// Banded affine-gap (Gotoh) x-drop seed extension, one direction, for Hopper
// (sm_90a). Kernel K1 of the port.
//
// Replaces repkiller_tpu/extend/banded_pallas.py `_make_kernel` (launched from
// `_direction`). Semantics: repkiller_tpu_torch/extend/banded.py
// `direction_plain`, which the tests hold against the Pallas kernel; this file
// must agree with it exactly on every output.
//
// Bound. Integer ALU work: about 30 int32 operations per band cell per row,
// over the rows each seed actually runs, at 64 INT32 lanes per SM. The bytes
// are few: each seed reads about 2 bytes per row at a random genome offset,
// and the genome (x and its reverse complement, 8.4 MB at 4.19 Mbp) stays in
// the 50 MB L2. A thread-per-seed kernel is far from that bound: its serial
// horizontal-gap chain makes a row cost ~W dependent steps, a warp runs until
// its longest seed dies, and a register-resident row of W cells per thread
// leaves room for only 8 warps per SM.
//
// Design: one warp per seed, blocks of 8 warps (256 threads).
//   - Lane l holds C = ceil(W/32) contiguous band cells o = l*C + c (C is a
//     template parameter, 1..3, so W <= 96, band <= 47); cells o >= W are
//     dead. Per cell a lane keeps H, E, IH and IE in registers; every lane
//     keeps the warp's best/bei/bej/bid.
//   - Per row i, the diagonal donor (o) is the cell's own register, the
//     vertical donor (o+1) the next cell in the lane or, for the lane's last
//     cell, the next lane's first (__shfl_down_sync).
//   - The horizontal gap F is the plain version's argmax-last max-plus scan
//     of w = ME + o*ext (its id from the last cell holding the maximum).
//     Each live cell packs (w - best)*128 + o into one int, so a plain max
//     keeps the largest w and, on ties, the last cell: a max over a lane's
//     C cells, five __shfl_up_sync + max steps over the lane aggregates,
//     then one more shuffle for the exclusive prefix. The donor's id comes
//     from its cell by a shuffle. A row's critical path is one cell plus
//     log-depth warp steps instead of W dependent cells.
//   - The row's maximum with its first (smallest o) argmax is one
//     __reduce_max_sync of (Hn - best)*128 + 127 - o; then the across-row
//     rule, the x-drop prune, and __any_sync decides whether the warp goes
//     on. A warp runs only its own seed's rows, so seeds that die early
//     free their warp slot at once.
//   - Both keys need every live value within 2^23 of best. Every value is
//     the score of a path of at most 2E + W steps, so |value| and best lie
//     within P = (2E + W) * (|match| + |mismatch| + |gap_open| +
//     |gap_extend|); the keys hold 2P + W*|gap_extend|. Settings where that
//     reaches 2^23 run in the wide kernel below (rk_banded_needs_scratch),
//     which packs no keys. For the same reason an x_drop above 2P prunes
//     nothing that 2P does not, and one below -2P - 1 prunes every cell at
//     row 0, as -2P - 1 does, so
//     x_drop is clamped to [-2P - 1, 2P] without changing any output: any
//     x_drop is taken (a huge one switches the drop off), and the threshold
//     best - x_drop stays far above DEAD.
//     Dead values (at most DEAD) are not masked in the recurrence: a dead
//     donor gives a value a little below NEG_INF, which every live value
//     beats and the prune resets, and its id is never selected.
//   - Bases: once per 32 rows, lane l reads the x byte of row i0 + l and the
//     y byte that enters the band at row i0 + l (y-step i0 + l + band), one
//     coalesced byte per lane each, broadcast per row with __shfl_sync. The
//     band's y window slides one cell per row (a __shfl_down_sync), its new
//     last cell taking that row's entering byte. The next 32 rows' bytes are
//     loaded before the current 32 rows run, so their L2 latency is off the
//     row's critical path. Reads are bounds-checked; 255 marks a position
//     outside the sequence.
//   - Slots at or past *n_live, and invalid seeds, write zeros and exit.
// What Hopper offers and this kernel does not use, and why: tensor cores
// (wgmma) multiply matrices, and the recurrence is an integer max-plus
// scan with no matrix product; TMA moves tiles, and a seed reads ~2 bytes
// per row at a random offset; shared memory is not needed, since the row
// lives across the warp's registers and moves by shuffles. At C = 1 the
// row loop is about 100 instructions (16 shuffles, one REDUX, one VOTE) for
// 31 cells, so the kernel is bound by instruction throughput, at 2.3x the
// INT32 bound of 30 operations per cell.
//
// Rows wider than REGISTER_W = 96 cells (band > 47), and scores whose values
// could leave the warp kernel's keys, run in banded_gotoh_wide_kernel: one
// thread per seed with the four DP rows in a global scratch buffer that the
// wrapper allocates (rk_banded_needs_scratch says when), the horizontal gap
// as the oracle's sequential scan, and the y codes read straight from cy. It
// takes every score and is right, not fast; no configuration in use takes
// it. The choice is made from the arguments before the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <stdlib.h>

#define NEG_INF (-(1 << 30))
#define DEAD (NEG_INF / 2)  // values at or below it are dead
#define FULL 0xffffffffu
#define REGISTER_W 96       // widest row of the warp kernel: 3 cells a lane
#define KEY_SPAN (1LL << 23)  // |value - best| the packed keys hold

struct Params {
    const int* px;
    const int* py;
    const uint8_t* valid;
    const uint8_t* cx;
    const uint8_t* cy;
    long long lx, ly;
    const int* n_live;
    int n;
    int base_off, step;
    int match, mismatch, x_drop;
    int E, band, gap_open, gap_extend, jcap;
    int* out;  // (5, n): ei, ej, gain, idents, alive
};

// Code at offset g of a code array of length len; 255 outside it.
__device__ __forceinline__ int code_at(const uint8_t* c, long long len,
                                       long long g) {
    return (g >= 0 && g < len) ? (int)c[g] : 255;
}

template <int C>
__global__ void __launch_bounds__(256) banded_gotoh_warp_kernel(Params p) {
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (s >= p.n) return;  // warp-uniform from here on
    const int n = p.n;
    if (s >= *p.n_live || !p.valid[s]) {
        if (lane < 5) p.out[lane * n + s] = 0;
        return;
    }
    const int b = p.band, W = 2 * p.band + 1;
    const int open = p.gap_open, ext = p.gap_extend, xd = p.x_drop;
    const int step = p.step;
    // offsets of x-step 1 and y-step 1; step i (j) is at base + step*(i-1)
    const long long xs = (long long)p.px[s] + p.base_off;
    const long long ys = (long long)p.py[s] + p.base_off;
    const int o0 = lane * C;  // band lane of this thread's first cell

    int H[C], Eg[C], IH[C], IE[C], Y[C];

    // Y[c]: code of y-step j = i - b + o of the current row i (255 outside
    // the sequence; the j range 1..jcap is checked where it is used).
    // Row 0: H(0,0) = 0; right of centre -(open + j*ext) while every y-step
    // 1..j lies inside the sequence, which for a contiguous run is its two
    // ends; then x-drop against best = 0.
    const bool y1_in = code_at(p.cy, p.ly, ys) != 255;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int o = o0 + c, j = o - b;
        Y[c] = code_at(p.cy, p.ly, ys + (long long)step * (j - 1));
        int h = NEG_INF;
        if (o < W) {
            if (j == 0)
                h = 0;
            else if (j > 0 && y1_in && Y[c] != 255)
                h = -(open + j * ext);
        }
        H[c] = (h < -xd) ? NEG_INF : h;
        Eg[c] = NEG_INF;
        IH[c] = 0;
        IE[c] = 0;
    }

    int best = 0, bei = 0, bej = 0, bid = 0;
    // the centre cell survives row 0 unless x_drop < 0 prunes every cell
    bool any0 = false;
#pragma unroll
    for (int c = 0; c < C; ++c) any0 = any0 || H[c] > NEG_INF;
    bool live = __any_sync(FULL, any0);
    // this lane's bytes of the 32-row block from row i0: x-step i0 + lane
    // and y-step i0 + b + lane (the byte entering the band at row i0 + lane)
    int xw = code_at(p.cx, p.lx, xs + (long long)step * lane);
    int yw = code_at(p.cy, p.ly, ys + (long long)step * (b + lane));
    for (int i0 = 1; i0 <= p.E && live; i0 += 32) {
        // the next block's bytes, loaded before this block's rows run
        const int xn = code_at(p.cx, p.lx, xs + (long long)step * (i0 + 31 + lane));
        const int yn = code_at(p.cy, p.ly, ys + (long long)step * (i0 + 31 + b + lane));
        const int rows = min(32, p.E - i0 + 1);
        for (int r = 0; r < rows; ++r) {
            const int i = i0 + r;
            const int xc = __shfl_sync(FULL, xw, r);
            const int yin = __shfl_sync(FULL, yw, r);
            // slide the y window one cell; cell W-1 takes y-step i + b
            const int ynext = __shfl_down_sync(FULL, Y[0], 1);
#pragma unroll
            for (int c = 0; c + 1 < C; ++c) Y[c] = Y[c + 1];
            Y[C - 1] = ynext;
#pragma unroll
            for (int c = 0; c < C; ++c)
                if (o0 + c == W - 1) Y[c] = yin;

            // vertical donors of the lane's last cell: the next lane's first.
            // Cells o >= W are dead in every row, so cell W-1 needs no mask;
            // only the last lane, whose shuffle returns its own first cell,
            // masks it, where that cell can be live (C > 1).
            int hdn = __shfl_down_sync(FULL, H[0], 1);
            const int ihdn = __shfl_down_sync(FULL, IH[0], 1);
            int edn = __shfl_down_sync(FULL, Eg[0], 1);
            const int iedn = __shfl_down_sync(FULL, IE[0], 1);
            if (C > 1 && lane == 31) {
                hdn = NEG_INF;
                edn = NEG_INF;
            }
            const bool xok = xc < 5;
            const int base = best;  // live values of this row lie near it

            int ME[C], IME[C], En[C], IEn[C], inc[C];
            bool yok[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int o = o0 + c, j = i - b + o;
                const int yc = Y[c];
                yok[c] = o < W && yc < 5 && j >= 1 && j <= p.jcap;
                const bool ism = yok[c] && xok && yc == xc && yc < 4;
                const int cn = c + 1 < C ? c + 1 : c;  // constant once unrolled
                const int hu = c + 1 < C ? H[cn] : hdn;
                const int ihu = c + 1 < C ? IH[cn] : ihdn;
                const int eu = c + 1 < C ? Eg[cn] : edn;
                const int ieu = c + 1 < C ? IE[cn] : iedn;
                // A dead donor gives a dead value a little below NEG_INF;
                // live values always beat it, the prune resets it, and the
                // id it carries is never selected.
                const int M = (xok && yok[c]) ? H[c] + (ism ? p.match : p.mismatch)
                                              : NEG_INF;
                const int IM = IH[c] + (ism ? 1 : 0);
                const int Ec1 = xok ? hu - open - ext : NEG_INF;
                const int Ec2 = xok ? eu - ext : NEG_INF;
                En[c] = max(Ec1, Ec2);
                IEn[c] = (Ec1 >= Ec2) ? ihu : ieu;
                ME[c] = max(M, En[c]);
                IME[c] = (M >= En[c]) ? IM : IEn[c];
                // F scan key (w - best)*128 + o of w = ME + o*ext: the max
                // is the largest w, the last cell on ties (argmax-last)
                inc[c] = (ME[c] > DEAD) ? (ME[c] - base + o * ext) * 128 + o : INT_MIN;
            }
            // inclusive max-scan of the keys: in the lane, ...
#pragma unroll
            for (int c = 1; c < C; ++c) inc[c] = max(inc[c], inc[c - 1]);
            // ... over the lanes' aggregates (a lane below d gets its own) ...
            int agg = inc[C - 1];
#pragma unroll
            for (int d = 1; d < 32; d *= 2)
                agg = max(agg, __shfl_up_sync(FULL, agg, d));
            // ... and, exclusive, the lanes before this one
            int pre = __shfl_up_sync(FULL, agg, 1);
            if (lane == 0) pre = INT_MIN;

            int Hn[C], IHn[C];
            int rl = INT_MIN;  // lane's row-max key (Hn - best)*128 + 127 - o
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const int cp = c > 0 ? c - 1 : 0;  // constant once unrolled
                const int dk = c > 0 ? max(pre, inc[cp]) : pre;  // cells < o
                const int src = dk & 127;  // the donor cell
                int fid = 0;
#pragma unroll
                for (int c2 = 0; c2 < C; ++c2) {
                    const int v = __shfl_sync(FULL, IME[c2], src / C);
                    if (src % C == c2) fid = v;
                }
                const int o = o0 + c;
                const int F = (dk != INT_MIN && yok[c])
                                  ? (dk >> 7) + base - open - o * ext
                                  : NEG_INF;
                Hn[c] = max(ME[c], F);
                IHn[c] = (ME[c] >= F) ? IME[c] : fid;
                if (Hn[c] > DEAD) rl = max(rl, (Hn[c] - base) * 128 + 127 - o);
            }
            // the row's max and its first argmax; a dead row (INT_MIN)
            // decodes to a gain far below best and is never taken
            const int gk = __reduce_max_sync(FULL, rl);
            const int g = (gk >> 7) + base;
            const int go = 127 - (gk & 127);
            int gid = 0;
#pragma unroll
            for (int c2 = 0; c2 < C; ++c2) {
                const int v = __shfl_sync(FULL, IHn[c2], go / C);
                if (go % C == c2) gid = v;
            }

            const int jb = i - b + go;
            if (g > best || (g == best && i + jb < bei + bej)) {
                best = g;
                bei = i;
                bej = jb;
                bid = gid;
            }
            const int thr = best - xd;
            bool any = false;
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const bool prune = Hn[c] < thr;
                H[c] = prune ? NEG_INF : Hn[c];
                Eg[c] = prune ? NEG_INF : En[c];
                IH[c] = IHn[c];
                IE[c] = IEn[c];
                any = any || H[c] > NEG_INF;
            }
            live = __any_sync(FULL, any);
            if (!live) break;
        }
        xw = xn;
        yw = yn;
    }

    if (lane == 0) {
        p.out[0 * n + s] = bei;
        p.out[1 * n + s] = bej;
        p.out[2 * n + s] = best;
        p.out[3 * n + s] = bid;
        p.out[4 * n + s] = live ? 1 : 0;
    }
}

// Code of y-step j (1-based) or 255 outside the sequence.
__device__ __forceinline__ int y_code(const Params& p, long long ys, int j) {
    return code_at(p.cy, p.ly, ys + (long long)p.step * (j - 1));
}

// W > REGISTER_W: one thread per seed, the recurrence of direction_plain with the
// horizontal gap as the oracle's sequential scan (same tie rules), and lane
// o of seed s of row array a (H, Eg, IH, IE) at scratch[(a * W + o) * n + s],
// so the threads of a warp touch neighbouring words.
__global__ void __launch_bounds__(128) banded_gotoh_wide_kernel(Params p,
                                                                int* scratch) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= p.n) return;
    const int n = p.n;
    if (s >= *p.n_live || !p.valid[s]) {
        for (int r = 0; r < 5; ++r) p.out[r * n + s] = 0;
        return;
    }
    const int b = p.band, W = 2 * p.band + 1;
    const int open = p.gap_open, ext = p.gap_extend, xd = p.x_drop;
    const long long xs = (long long)p.px[s] + p.base_off;
    const long long ys = (long long)p.py[s] + p.base_off;
    const size_t row = (size_t)W * n;
    int* H = scratch + s;
    int* Eg = H + row;
    int* IH = Eg + row;
    int* IE = IH + row;

    bool ok = true, live = false;
    for (int o = 0; o < W; ++o) {
        const int j = o - b;
        int h = NEG_INF;
        if (j == 0) {
            h = 0;
        } else if (j > 0) {
            ok = ok && (y_code(p, ys, j) != 255);
            h = ok ? -(open + j * ext) : NEG_INF;
        }
        h = (h < -xd) ? NEG_INF : h;
        live = live || h > NEG_INF;
        H[(size_t)o * n] = h;
        Eg[(size_t)o * n] = NEG_INF;
        IH[(size_t)o * n] = 0;
        IE[(size_t)o * n] = 0;
    }

    int best = 0, bei = 0, bej = 0, bid = 0;
    for (int i = 1; i <= p.E && live; ++i) {
        const long long gx = xs + (long long)p.step * (i - 1);
        const int xc = (gx >= 0 && gx < p.lx) ? (int)p.cx[gx] : 255;
        const bool xok = xc < 5;

        int fcur = NEG_INF, ficur = 0;
        int pME = NEG_INF, pIME = 0;
        int g = NEG_INF, go = 0, gid = 0;
        for (int o = 0; o < W; ++o) {
            const size_t at = (size_t)o * n, up_at = at + n;
            const int j = i - b + o;
            const int yc = y_code(p, ys, j);
            const bool yok = yc < 5 && j >= 1 && j <= p.jcap;
            const bool ism = yok && xok && yc == xc && yc < 4;
            const int sub = ism ? p.match : p.mismatch;
            const bool up = o + 1 < W;
            const int hd = H[at], ihd = IH[at];
            const int hu = up ? H[up_at] : NEG_INF;
            const int ihu = up ? IH[up_at] : 0;
            const int eu = up ? Eg[up_at] : NEG_INF;
            const int ieu = up ? IE[up_at] : 0;

            const int M = (hd > NEG_INF && xok && yok) ? hd + sub : NEG_INF;
            const int IM = ihd + (ism ? 1 : 0);
            const int Ec1 = (hu > NEG_INF && xok) ? hu - open - ext : NEG_INF;
            const int Ec2 = (eu > NEG_INF && xok) ? eu - ext : NEG_INF;
            const int En = max(Ec1, Ec2);
            const int IEn = (Ec1 >= Ec2) ? ihu : ieu;
            const int ME = max(M, En);
            const int IME = (M >= En) ? IM : IEn;

            const int c1 = (pME > NEG_INF) ? pME - open - ext : NEG_INF;
            const int c2 = (fcur > NEG_INF) ? fcur - ext : NEG_INF;
            ficur = (c1 >= c2) ? pIME : ficur;
            fcur = max(c1, c2);
            const int F = yok ? fcur : NEG_INF;

            const int Hn = max(ME, F);
            const int IHn = (ME >= F) ? IME : ficur;
            pME = ME;
            pIME = IME;
            if (Hn > g) {
                g = Hn;
                go = o;
                gid = IHn;
            }
            H[at] = Hn;
            IH[at] = IHn;
            Eg[at] = En;
            IE[at] = IEn;
        }

        const int jb = i - b + go;
        if (g > best || (g == best && i + jb < bei + bej)) {
            best = g;
            bei = i;
            bej = jb;
            bid = gid;
        }
        const int thr = best - xd;
        live = false;
        for (int o = 0; o < W; ++o) {
            const size_t at = (size_t)o * n;
            if (H[at] < thr) {
                H[at] = NEG_INF;
                Eg[at] = NEG_INF;
            }
            live = live || H[at] > NEG_INF;
        }
        if (!live) break;
    }

    p.out[0 * n + s] = bei;
    p.out[1 * n + s] = bej;
    p.out[2 * n + s] = best;
    p.out[3 * n + s] = bid;
    p.out[4 * n + s] = live ? 1 : 0;
}

template <int C>
static void launch(const Params& p, cudaStream_t stream) {
    const int warps = 8;  // seeds per block
    banded_gotoh_warp_kernel<C><<<(p.n + warps - 1) / warps, 32 * warps, 0,
                                  stream>>>(p);
}

// P of the header note: no value, and not best, lies further than P from 0.
static long long path_span(int band, int match, int mismatch, int E,
                           int gap_open, int gap_extend) {
    const long long steps = 2LL * (E > 0 ? E : 0) + 2LL * band + 1;
    return steps * (llabs(match) + llabs(mismatch) + llabs(gap_open) +
                    llabs(gap_extend));
}

extern "C" {

// Which kernel a launch with these settings runs: 0 the warp kernel, 1 the
// wide kernel, which needs the (4, 2 * band + 1, n) int32 scratch buffer;
// -1 when the settings are invalid (band < 0). The warp kernel takes rows of
// at most REGISTER_W cells whose values all fit its packed keys.
int rk_banded_needs_scratch(int band, int match, int mismatch, int E,
                            int gap_open, int gap_extend) {
    if (band < 0) return -1;
    const long long W = 2LL * band + 1;
    if (W > REGISTER_W) return 1;
    const long long keys = 2 * path_span(band, match, mismatch, E, gap_open,
                                         gap_extend) + W * llabs(gap_extend);
    return keys >= KEY_SPAN ? 1 : 0;
}

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok),
// cudaErrorInvalidValue for band < 0 or a missing scratch buffer. All
// pointers are device pointers; n_live points to one int32 on the device.
// scratch (int32, 4 * (2 * band + 1) * n) is used, and required, when
// rk_banded_needs_scratch gives 1.
int rk_banded_gotoh(const int* px, const int* py, const uint8_t* valid,
                    const uint8_t* cx, long long lx, const uint8_t* cy,
                    long long ly, const int* n_live, int n, int base_off,
                    int step, int match, int mismatch, int x_drop, int E,
                    int band, int gap_open, int gap_extend, int jcap, int* out,
                    int* scratch, void* stream) {
    const int wide = rk_banded_needs_scratch(band, match, mismatch, E,
                                             gap_open, gap_extend);
    if (wide < 0 || (wide && n > 0 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const int W = 2 * band + 1;
    // x_drop clamped to [-2P - 1, 2P] (header note), which changes no output
    const long long span = 2 * path_span(band, match, mismatch, E, gap_open,
                                         gap_extend);
    const int xd = (int)(x_drop < -span - 1 ? -span - 1
                                            : (x_drop > span ? span : x_drop));
    Params p{px, py, valid, cx, cy, lx, ly, n_live, n, base_off, step,
             match, mismatch, xd, E, band, gap_open, gap_extend, jcap, out};
    cudaStream_t st = (cudaStream_t)stream;
    if (wide) {
        const int threads = 128;
        banded_gotoh_wide_kernel<<<(n + threads - 1) / threads, threads, 0,
                                   st>>>(p, scratch);
    } else if (W <= 32) {
        launch<1>(p, st);
    } else if (W <= 64) {
        launch<2>(p, st);
    } else {
        launch<3>(p, st);
    }
    return (int)cudaGetLastError();
}

const char* rk_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
