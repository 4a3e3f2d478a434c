// K9's W-pass plan (resize.cu, pass_cols_kernel): from the shape alone, the
// rows a lane sums, the outputs a block takes, the source columns a staged row
// holds, and the block's shared memory, laid out here once. Plain C++ (no CUDA
// header), so that resize.cu's host code and the CPU test of the plan
// (tests/test_torch_resize_plan.py, built with the host's C++ compiler) read
// the same definition.
#pragma once

#ifdef __CUDACC__
#define IPT_HD __host__ __device__
#else
#define IPT_HD
#endif

namespace ipt {
namespace cols {

constexpr int WARPS = 8;                  // warps a block
constexpr int STAGES = 2;                 // tile buffers a block (one tile's copies in flight)
constexpr int MANY_TAPS = 16;             // above this many taps a lane sums one row, else two
constexpr int OUTS[] = {64, 32, 16, 8};   // outputs a block (a multiple of its warps), most first
constexpr long long REACH_SLACK = 4;      // columns beyond the reach that the scale gives

// Rows a lane sums (a tile is 32 of them a lane): one where the taps are many
// (their own length spreads each output's fixed costs, and half the rows a
// tile leave room for more outputs a block).
constexpr int lane_rows(long long taps) { return taps > MANY_TAPS ? 1 : 2; }

// A staged table row's taps, a multiple of 4 (16-byte vector loads).
IPT_HD constexpr long long table_row(long long taps) { return (taps + 3) / 4 * 4; }

// The fewest bytes, at least n, that are an odd number of 4-byte words: rows
// at that pitch put 32 lanes' words in 32 banks.
constexpr long long odd_words(long long n) { return 4 * (((n + 3) / 4) | 1); }

// The source columns that `outs` neighbouring outputs' tables reach at most,
// as ops/_exact.py::calc_contributions makes them: their windows start
// cols / out_size columns apart and hold `taps` columns (mirrored indices at
// an edge stay inside the window's width), with REACH_SLACK to spare; never
// more than the row.
constexpr long long reach(long long cols, long long out_size, long long taps, long long outs) {
    const long long first_to_last = ((outs < out_size ? outs : out_size) - 1) * cols;
    const long long r = (first_to_last + out_size - 1) / out_size + taps + REACH_SLACK;
    return r < cols ? r : cols;
}

// The block's dynamic shared memory, in this order: the output tile (32 * K
// rows of out_pitch bytes), then, where the pass is tiled, the tables (outs
// rows of table_row(taps) byte offsets, weights and addends) and STAGES
// buffers of 32 * K source rows of pitch bytes. Every part starts 16-byte
// aligned: out_pitch is a whole number of words and a tile 32 or 64 rows,
// and a table row a multiple of 4 entries.
IPT_HD constexpr long long tables_at(int lane_rows, int out_pitch) {
    return 32LL * lane_rows * out_pitch;
}
IPT_HD constexpr long long staged_at(int lane_rows, int out_pitch, int outs, long long taps) {
    return tables_at(lane_rows, out_pitch) + outs * table_row(taps) * 20;
}

struct Plan {
    bool tiled;      // each tile's source rows staged in shared memory; else read from global
    int outs;        // outputs a block
    int lane_rows;   // rows a lane (a tile is 32 * lane_rows rows)
    int span;        // source columns a staged row holds (0: gathered)
    int pitch;       // bytes a staged source row takes
    int out_pitch;   // bytes an output row of the tile takes
    long long smem;  // the block's dynamic shared memory
};

// The plan for rows of `cols` pixels of `c` channels to `out_size` with
// `taps` taps: tiled with the most OUTS whose shared memory is within `aim`
// (what each of two blocks on an SM may take), else the fewest within `most`
// (what one block may take); gathered where even those do not fit.
inline Plan plan(long long cols, int c, long long out_size, long long taps, long long most,
                 long long aim) {
    const int k = lane_rows(taps);
    Plan fewest{};
    for (const int outs : OUTS) {
        const long long span = reach(cols, out_size, taps, outs);
        const long long pitch = odd_words(span * c + 8), out_pitch = odd_words(outs * c);
        const long long smem = staged_at(k, static_cast<int>(out_pitch), outs, taps) +
                               STAGES * 32LL * k * pitch;
        if (smem > most) continue;
        fewest = {true, outs, k, static_cast<int>(span), static_cast<int>(pitch),
                  static_cast<int>(out_pitch), smem};
        if (smem <= aim) return fewest;
    }
    if (fewest.tiled) return fewest;
    const int out_pitch = static_cast<int>(odd_words(OUTS[0] * c));
    return {false, OUTS[0], k, 0, 0, out_pitch, tables_at(k, out_pitch)};
}

}  // namespace cols
}  // namespace ipt
