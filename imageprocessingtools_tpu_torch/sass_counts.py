"""Count the machine instructions of the port's CUDA kernels (SASS, sm_90a).

Run from the root of the repository, on a machine with the CUDA toolkit:

    python -m imageprocessingtools_tpu_torch.sass_counts [file.cu ...]

Each source (by default every ``csrc/*.cu``) is compiled to a cubin with the
build's own flags and ``-Xptxas -v``; ``cuobjdump -sass`` lists its
instructions. One JSON line per kernel function: its registers, shared
memory and spills as ptxas reports them, the number of instructions, and the
static count of each class below (an instruction in a loop counts once):
the f64 operations, conversions, memory operations, and the byte and copy
work of K9 (``PRMT``, ``SHF``; the W pass's rows come by ``LDGSTS``,
cp.async).
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

from imageprocessingtools_tpu_torch.kernels import _build

# class -> opcode test (the opcode without its predicate, e.g. "DADD" or
# "I2F.F64.U32")
CLASSES = {
    "DADD": lambda op: op.startswith("DADD"),
    "DMUL": lambda op: op.startswith("DMUL"),
    "DFMA": lambda op: op.startswith("DFMA"),
    "DSETP": lambda op: op.startswith("DSETP"),
    "I2F.F64": lambda op: op.startswith("I2F") and ".F64" in op,
    "F2I.F64": lambda op: op.startswith("F2I") and ".F64" in op,
    "FRND.F64": lambda op: op.startswith("FRND") and ".F64" in op,
    "MUFU": lambda op: op.startswith("MUFU"),
    "LDG": lambda op: op.startswith("LDG") and not op.startswith("LDGSTS"),
    "LDS": lambda op: op.startswith("LDS"),
    "STS": lambda op: op.startswith("STS"),
    "STG": lambda op: op.startswith("STG"),
    "LDGSTS": lambda op: op.startswith("LDGSTS"),  # cp.async: how K9's W pass stages its rows
    "SHFL": lambda op: op.startswith("SHFL"),
    "PRMT": lambda op: op.startswith("PRMT"),      # K9: a byte out of a word, one a tap
    "SHF": lambda op: op.split(".")[0] == "SHF",   # funnel and 64-bit shifts
    "ATOMS": lambda op: op.startswith("ATOMS"),
    "IDP": lambda op: op.startswith("IDP"),
}
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
_PTXAS = re.compile(r"Function properties for (\S+)|Compiling entry function '(\S+)'"
                    r"|Used (\d+) registers|(\d+) bytes smem|(\d+) bytes spill stores")


def _cuobjdump() -> str:
    return os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")


def counts(source: Path) -> list[dict]:
    """Compile ``source`` to a cubin and summarize each kernel function."""
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-cubin",
                               "-I", str(_build.CSRC), "-o", cubin, str(source)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        sass = subprocess.run([_cuobjdump(), "-sass", cubin], capture_output=True, text=True,
                              check=True).stdout
    return summarize(source.name, proc.stderr, sass)


def summarize(source_name: str, ptxas_log: str, sass: str) -> list[dict]:
    """One row per function of ``cuobjdump -sass`` output, with ptxas's
    registers, shared memory and spills for it from ``ptxas_log``."""
    ptxas, name = {}, None
    for m in _PTXAS.finditer(ptxas_log):
        if m.group(2):
            name = m.group(2)
            ptxas[name] = {}
        elif name and m.group(3):
            ptxas[name]["registers"] = int(m.group(3))
        elif name and m.group(4):
            ptxas[name]["smem_bytes"] = int(m.group(4))
        elif name and m.group(5):
            ptxas[name]["spill_store_bytes"] = int(m.group(5))
    rows, fn, ops = [], None, collections.Counter()

    def flush():
        if fn is not None:
            row = {"source": source_name, "function": fn, **ptxas.get(fn, {}),
                   "instructions": sum(ops.values())}
            for cls, test in CLASSES.items():
                row[cls] = sum(n for op, n in ops.items() if test(op))
            rows.append(row)

    for line in sass.splitlines():
        if "Function :" in line:
            flush()
            fn, ops = line.split("Function :", 1)[1].strip(), collections.Counter()
        elif fn is not None:
            m = _INSTR.search(line)
            if m:
                ops[m.group(1)] += 1
    flush()
    return rows


def main(argv: list[str]) -> int:
    for source in [Path(a) for a in argv] or _build.sources():
        for row in counts(source):
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
