"""The SASS counter's parsing (``sass_counts.py``), on the CPU.

Compiling needs the CUDA toolkit; these tests hold the part that turns
ptxas's log and ``cuobjdump -sass`` text into counts. Exact: the inputs are
fixed text.
"""

from __future__ import annotations

from imageprocessingtools_tpu_torch import sass_counts

_PTXAS = """\
ptxas info    : Compiling entry function '_Z1kPd' for 'sm_90a'
ptxas info    : Function properties for _Z1kPd
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 2048 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'
ptxas info    : Used 10 registers, used 0 barriers, 368 bytes cmem[0]
"""

_SASS = """\
\tcode for sm_90a
\t\tFunction : _Z1kPd
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   DADD R2, R4, R6 ;
        /*0020*/               @P0 DMUL R2, R2, R8 ;
        /*0030*/              @!P1 DADD R2, R2, -R10 ;
        /*0040*/                   I2F.F64.U32 R4, R12 ;
        /*0050*/                   LDS.64 R6, [R0] ;
        /*0060*/                   LDG.E.128.CONSTANT R8, desc[UR4][R2.64] ;
        /*0070*/                   DSETP.GEU.AND P0, PT, R2, R4, PT ;
        /*0080*/                   ATOMS.POPC.INC.32 RZ, [R3+UR4] ;
        /*0090*/                   IDP.4A.U8.U8 R5, R6, R7, RZ ;
        /*00a0*/                   LDGSTS.E [R17], desc[UR12][R14.64] ;
        /*00b0*/                   PRMT R30, R38, 0x4440, RZ ;
        /*00c0*/                   SHF.R.W.U32 R38, R38, R20, R31 ;
        /*00d0*/                   SHFL.BFLY PT, R12, R7, 0x10, 0x1f ;
        /*00e0*/                   EXIT ;
\t\t..........
\t\tFunction : _Z1gv
        /*0000*/                   MUFU.RSQ R0, R1 ;
        /*0010*/                   STG.E desc[UR4][R2.64], R0 ;
"""


def test_summarize_counts_each_class_per_function():
    rows = sass_counts.summarize("k.cu", _PTXAS, _SASS)
    assert [r["function"] for r in rows] == ["_Z1kPd", "_Z1gv"]
    k, g = rows
    assert (k["registers"], k["smem_bytes"], k["spill_store_bytes"]) == (72, 2048, 8)
    assert k["instructions"] == 15
    assert (k["DADD"], k["DMUL"], k["DSETP"], k["I2F.F64"], k["LDS"], k["LDG"]) == (2, 1, 1, 1, 1, 1)
    assert (k["ATOMS"], k["IDP"]) == (1, 1)
    assert (k["LDGSTS"], k["PRMT"], k["SHF"], k["SHFL"]) == (1, 1, 1, 1)
    assert k["DFMA"] == k["MUFU"] == k["STG"] == g["ATOMS"] == 0
    assert g["registers"] == 10 and "smem_bytes" not in g
    assert (g["instructions"], g["MUFU"], g["STG"]) == (2, 1, 1)
