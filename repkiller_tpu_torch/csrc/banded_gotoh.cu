// Banded affine-gap (Gotoh) x-drop seed extension, one direction, for Hopper
// (sm_90a). Kernel K1 of the port.
//
// Replaces repkiller_tpu/extend/banded_pallas.py `_make_kernel` (launched from
// `_direction`). Semantics: repkiller_tpu_torch/extend/banded.py
// `direction_plain`, which the tests hold against the Pallas kernel; this file
// must agree with it exactly on every output.
//
// Design: one thread per seed, blocks of 128 threads. A seed's DP row of
// W = 2*band+1 cells lives in registers: the arrays are indexed only with
// compile-time indices (loops over WMAX fully unrolled, lanes o >= W masked),
// so nothing spills for W <= 33. The row is updated in place in ascending o:
// cell o reads the old H[o] (diagonal donor) and the old H[o+1] (vertical
// donor) before it is overwritten, and the horizontal donor F is the oracle's
// sequential scan along o (repkiller_tpu/oracle/banded.py), which a thread
// does naturally, with the same tie rules. The y bases of the band slide one
// lane per row in a register window Y, so each row loads one x and one y byte.
// Bases are read straight from the uint8 code arrays with bounds checks (no
// pre-gathered windows as on the TPU). A seed exits as soon as all of its
// cells are dead, or at row E.
//
// Bound: integer ALU work per cell (~30 operations), and warp divergence where
// seeds of one warp die at different rows. Global traffic is a few bytes per
// row per seed. Packed 2-bit reads and a warp per seed are later work.
//
// Rows wider than 65 cells (band > 32) run in a second kernel,
// banded_gotoh_wide_kernel: the same recurrence with the four DP rows in a
// global scratch buffer that the wrapper allocates, and the y codes read
// straight from cy. It is right, not fast; no configuration in use takes it.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-(1 << 30))

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

template <int WMAX>
__global__ void __launch_bounds__(128) banded_gotoh_kernel(Params p) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= p.n) return;
    const int n = p.n;
    if (s >= *p.n_live || !p.valid[s]) {
#pragma unroll
        for (int r = 0; r < 5; ++r) p.out[r * n + s] = 0;
        return;
    }
    const int b = p.band, W = 2 * p.band + 1;
    const int open = p.gap_open, ext = p.gap_extend, xd = p.x_drop;
    const long long xs = (long long)p.px[s] + p.base_off;
    const long long ys = (long long)p.py[s] + p.base_off;

    int H[WMAX], Eg[WMAX], IH[WMAX], IE[WMAX], Y[WMAX];

    // Y[o]: code of y-step j = i - b + o in the current row i; 255 outside
    // the sequence. The j range (1 <= j <= jcap) is checked where it is used.
    // Row 0: H(0,0) = 0; right of centre -(open + j*ext) while every y-step
    // 1..j lies inside the sequence; then x-drop against best = 0.
    bool ok = true;
#pragma unroll
    for (int o = 0; o < WMAX; ++o) {
        const int j = o - b;
        const long long g = ys + (long long)p.step * (j - 1);
        Y[o] = (g >= 0 && g < p.ly) ? (int)p.cy[g] : 255;
        int h = NEG_INF;
        if (o < W) {
            if (j == 0) {
                h = 0;
            } else if (j > 0) {
                ok = ok && (Y[o] != 255);
                h = ok ? -(open + j * ext) : NEG_INF;
            }
        }
        H[o] = (h < -xd) ? NEG_INF : h;
        Eg[o] = NEG_INF;
        IH[o] = 0;
        IE[o] = 0;
    }

    int best = 0, bei = 0, bej = 0, bid = 0;
    bool live = true;  // the centre cell (0) survives row 0
    for (int i = 1; i <= p.E; ++i) {
        // slide the y window one lane; the new last lane is j = i + b
        const long long gy = ys + (long long)p.step * (i + b - 1);
        const int ynew = (gy >= 0 && gy < p.ly) ? (int)p.cy[gy] : 255;
#pragma unroll
        for (int o = 0; o < WMAX; ++o) {
            const int nxt = Y[o + 1 < WMAX ? o + 1 : o];
            Y[o] = (o == W - 1) ? ynew : nxt;
        }
        const long long gx = xs + (long long)p.step * (i - 1);
        const int xc = (gx >= 0 && gx < p.lx) ? (int)p.cx[gx] : 255;
        const bool xok = xc < 5;

        int fcur = NEG_INF, ficur = 0;   // horizontal scan state along o
        int pME = NEG_INF, pIME = 0;     // ME, IME of lane o-1
        int g = NEG_INF, go = 0, gid = 0;  // row max, first argmax
#pragma unroll
        for (int o = 0; o < WMAX; ++o) {
            if (o < W) {
                const int j = i - b + o;
                const int yc = Y[o];
                const bool yok = yc < 5 && j >= 1 && j <= p.jcap;
                const bool ism = yok && xok && yc == xc && yc < 4;
                const int sub = ism ? p.match : p.mismatch;
                const int o1 = o + 1 < WMAX ? o + 1 : o;
                const bool up = o + 1 < W;
                const int hd = H[o], ihd = IH[o];
                const int hu = up ? H[o1] : NEG_INF;
                const int ihu = up ? IH[o1] : 0;
                const int eu = up ? Eg[o1] : NEG_INF;
                const int ieu = up ? IE[o1] : 0;

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
                H[o] = Hn;
                IH[o] = IHn;
                Eg[o] = En;
                IE[o] = IEn;
            }
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
#pragma unroll
        for (int o = 0; o < WMAX; ++o) {
            if (o < W) {
                if (H[o] < thr) {
                    H[o] = NEG_INF;
                    Eg[o] = NEG_INF;
                }
                live = live || H[o] > NEG_INF;
            }
        }
        if (!live) break;
    }

    p.out[0 * n + s] = bei;
    p.out[1 * n + s] = bej;
    p.out[2 * n + s] = best;
    p.out[3 * n + s] = bid;
    p.out[4 * n + s] = live ? 1 : 0;
}

// Code of y-step j (1-based) or 255 outside the sequence.
__device__ __forceinline__ int y_code(const Params& p, long long ys, int j) {
    const long long g = ys + (long long)p.step * (j - 1);
    return (g >= 0 && g < p.ly) ? (int)p.cy[g] : 255;
}

// W > 65: banded_gotoh_kernel's recurrence, line for line, with lane o of
// seed s of row array a (H, Eg, IH, IE) at scratch[(a * W + o) * n + s], so
// the threads of a warp touch neighbouring words.
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

    bool ok = true;
    for (int o = 0; o < W; ++o) {
        const int j = o - b;
        int h = NEG_INF;
        if (j == 0) {
            h = 0;
        } else if (j > 0) {
            ok = ok && (y_code(p, ys, j) != 255);
            h = ok ? -(open + j * ext) : NEG_INF;
        }
        H[(size_t)o * n] = (h < -xd) ? NEG_INF : h;
        Eg[(size_t)o * n] = NEG_INF;
        IH[(size_t)o * n] = 0;
        IE[(size_t)o * n] = 0;
    }

    int best = 0, bei = 0, bej = 0, bid = 0;
    bool live = true;
    for (int i = 1; i <= p.E; ++i) {
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

template <int WMAX>
static void launch(const Params& p, cudaStream_t stream) {
    const int threads = 128;
    const int blocks = (p.n + threads - 1) / threads;
    banded_gotoh_kernel<WMAX><<<blocks, threads, 0, stream>>>(p);
}

extern "C" {

// Launches K1 on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers; n_live points to one int32 on the device.
// scratch (int32, 4 * W * n) is used, and required, only when W > 65.
int rk_banded_gotoh(const int* px, const int* py, const uint8_t* valid,
                    const uint8_t* cx, long long lx, const uint8_t* cy,
                    long long ly, const int* n_live, int n, int base_off,
                    int step, int match, int mismatch, int x_drop, int E,
                    int band, int gap_open, int gap_extend, int jcap, int* out,
                    int* scratch, void* stream) {
    Params p{px, py, valid, cx, cy, lx, ly, n_live, n, base_off, step,
             match, mismatch, x_drop, E, band, gap_open, gap_extend, jcap, out};
    cudaStream_t st = (cudaStream_t)stream;
    const int W = 2 * band + 1;
    if (n <= 0) return 0;
    if (band < 0 || (W > 65 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    if (W <= 17) {
        launch<17>(p, st);
    } else if (W <= 33) {
        launch<33>(p, st);
    } else if (W <= 65) {
        launch<65>(p, st);
    } else {
        const int threads = 128;
        banded_gotoh_wide_kernel<<<(n + threads - 1) / threads, threads, 0,
                                   st>>>(p, scratch);
    }
    return (int)cudaGetLastError();
}

const char* rk_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
