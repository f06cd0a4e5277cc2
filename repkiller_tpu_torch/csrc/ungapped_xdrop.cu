// Ungapped x-drop seed extension, one direction, for Hopper (sm_90a). Kernel
// K2 of the port.
//
// Replaces repkiller_tpu/extend/ungapped_pallas.py `_make_kernel` (launched
// from `_direction`). Semantics: repkiller_tpu_torch/extend/ungapped.py
// `direction_plain`, which the tests hold against the Pallas kernel, the XLA
// `extend/ungapped._direction` and oracle.pipeline._directional_gain; this
// file must agree with it exactly on every output. Per seed, step g reads
// x = px + base_off + step*g (and the same for y):
//   - a step is valid when both positions lie in the sequences, their codes
//     are < 5 and the seed is valid; N (code 4) is valid but never a match;
//   - s += match or mismatch; rm = max(rm, max(s, 0));
//   - the seed stops BEFORE using step g when g is invalid or
//     s <= rm - x_drop (rm >= 0, so x_drop = 2^31 - 1 cannot overflow);
//   - otherwise s > best (strict: ties keep the earlier step) records
//     best = s, ext = g + 1 and the identities so far.
// The state starts at zero, so a seed that never gains gives (0, 0, 0).
// Sums wrap as torch's int32 sums do.
//
// Bound. The work is about 12 int32 operations per step a seed examines
// and the bytes are few (the genome stays in the 50 MB L2), so the bound is
// the INT32 rate. On the ungapped headline's anchor set (393,127 seeds) the
// steps are skewed: a mean of 19, 95% of the seeds stop within 32 steps,
// and the longest runs 1,534. A thread that walks its seed one dependent
// byte load at a time (the earlier design) is bound by the longest chains:
// on that set on an H100 80GB HBM3 at 700 W, clearing the 45 seeds over
// 256 steps took it from 0.248 to 0.107 ms, and clearing all 18,488 over
// 32 steps to 0.089 ms.
//
// Design: a persistent grid (SMs x resident blocks, blocks of 8 warps).
// Each warp takes groups of 32 consecutive slots by grid stride, up to n;
// *n_live is read once per warp, and slots at or past it are written as
// zeros in the same loop. Per group:
//   - Reads: for each of the group's 32 seeds in turn, lane l reads the x
//     and y bytes of step l, a coalesced 32-byte read each, and two
//     __ballot_sync give the seed's 32-bit masks of valid steps and of
//     matches, which pass through shared memory to the seed's own lane.
//     The reads of 8 seeds are issued before any is used. A seed whose 32
//     steps lie inside both sequences is read at a 32-bit offset kept in
//     shared memory, unchecked (without predicates when the whole group is
//     such); the others bounds-checked, 255 marking a position outside the
//     sequence.
//   - Phase A, a lane per seed: the recurrence over steps 0..31 from the two
//     masks, with no load on its chain. This ends 95% of the seeds. The
//     identities at the best step are a popcount of the match mask.
//   - Phase B, a warp per long seed: the lanes whose seed is still live after
//     32 steps (__ballot_sync) are taken one at a time (__ffs); their carries
//     (s, rm, identities, best, ext, best identities, positions) come by
//     __shfl_sync. The warp runs windows of 32 * K steps, K consecutive
//     steps a lane: lane-local prefixes, then warp scans of the lanes'
//     totals (__shfl_up_sync) give each step's score and identities, and a
//     lane-local max then a warp max-scan its running max. The first stop
//     is the first lane with a stop (__ballot_sync) and its first step. The
//     window's best among the steps before the stop is __reduce_max_sync of
//     the lanes' first maxima, and its first argmax the lowest lane that
//     holds it: two steps and no packed key, so any score is taken. The
//     best moves only on a strictly greater window best, which gives the
//     plain version's first argmax. A window's chain is about ten dependent
//     shuffles, whatever K. Most long seeds stop within steps 32..63, so
//     that window has K = 1; later ones K = SPL, which divides the chain
//     per step by SPL for the few seeds in long repeats.
// What Hopper offers and this kernel does not use: tensor cores (no matrix
// product) and TMA (each seed reads 2 x 32 contiguous bytes a chunk at a
// random offset, which a warp reads coalesced into registers).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define WARPS 8     // warps per block
#define BATCH 8     // seeds whose loads are issued together
#define SPL 4       // Phase B: steps per lane, a window of 32 * SPL steps

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
    int E;
    int* out;  // (3, n): ext, gain, idents
};

// int32 sums that wrap, as torch's do.
__device__ __forceinline__ int wadd(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
    return (int)((unsigned)a - (unsigned)b);
}

// Code at offset g of a code array of length len; 255 outside it.
__device__ __forceinline__ int code_at(const uint8_t* c, long long len,
                                       long long g) {
    return (g >= 0 && g < len) ? (int)c[g] : 255;
}

// Whether offsets x0 .. x0 + last all lie in [0, min(len, 2^31)), so that
// they can be computed in 32 bits and read unchecked.
__device__ __forceinline__ bool span_inside(long long x0, long long last,
                                              long long len) {
    const long long lo = last < 0 ? x0 + last : x0;
    const long long hi = last < 0 ? x0 : x0 + last;
    return lo >= 0 && hi < (len < INT_MAX ? len : (long long)INT_MAX);
}

// Phase A's reads for a group: for each seed j of the group in turn, lane l
// reads the x and y bytes of step l, and two ballots give seed j's masks of
// valid steps and of matches, which lane 0 stores to masks[j]. seed_at
// holds the seeds' 32-bit offsets of step 0; only seeds in `innerm` are
// read. ALL_INNER (every seed's 32 steps lie inside both sequences): the
// reads need no predicate.
template <bool ALL_INNER>
__device__ __forceinline__ void read_masks(const uint2* seed_at,
                                           unsigned innerm,
                                           const uint8_t* cxl,
                                           const uint8_t* cyl, int lane,
                                           uint2* masks) {
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += BATCH) {
        int a[BATCH], c[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const uint2 q = seed_at[j0 + b];
            if (ALL_INNER) {
                a[b] = cxl[q.x];
                c[b] = cyl[q.y];
            } else {
                const bool in = innerm >> (j0 + b) & 1;
                a[b] = in ? (int)cxl[q.x] : 255;
                c[b] = in ? (int)cyl[q.y] : 255;
            }
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
            const unsigned okb = __ballot_sync(FULL, a[b] < 5 && c[b] < 5);
            const unsigned eqb = __ballot_sync(FULL, a[b] == c[b] && a[b] < 4);
            if (lane == 0) masks[j0 + b] = make_uint2(okb, eqb);
        }
    }
}

// Phase B's reads: lane l's K bytes of x and of y at gx + step*i, gy +
// step*i (255 outside the sequences, and everywhere unless `on`).
template <int K>
__device__ __forceinline__ void read_window(const Params& p, long long gx,
                                            long long gy, bool on, int (&a)[K],
                                            int (&c)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const long long o = (long long)p.step * i;
        a[i] = on ? code_at(p.cx, p.lx, gx + o) : 255;
        c[i] = on ? code_at(p.cy, p.ly, gy + o) : 255;
    }
}

// Phase B: the window of 32 * K steps of a long seed from step g0, lane l
// holding the bytes of steps g0 + K*l .. g0 + K*l + K - 1, against the
// carries (score sc, running max rmc, identities idc; best bb at step be
// with bi identities) -> whether the seed stops in it; if not, the carries
// move to the window's end. Steps at or past E count as stops, which ends
// the seed where the plain version ends it.
template <int K>
__device__ __forceinline__ bool window(const int (&a)[K], const int (&c)[K],
                                       int g0, int E, int lane, int m, int mm,
                                       int xd, int& sc, int& rmc, int& idc,
                                       int& bb, int& be, int& bi) {
    // lane-local prefixes of the score change and the matches
    int ds[K], di[K];
    unsigned bad = 0;  // bit i: step i of the lane is invalid
#pragma unroll
    for (int i = 0; i < K; ++i) {
        const bool eq = a[i] == c[i] && a[i] < 4;
        if (!(a[i] < 5 && c[i] < 5) || g0 + K * lane + i >= E) bad |= 1u << i;
        ds[i] = wadd(i ? ds[i - 1] : 0, eq ? m : mm);
        di[i] = (i ? di[i - 1] : 0) + (eq ? 1 : 0);
    }
    // the lanes up to this one: warp scans of the lanes' totals
    int ps = ds[K - 1], pi = di[K - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int vs = __shfl_up_sync(FULL, ps, d);
        const int vi = __shfl_up_sync(FULL, pi, d);
        if (lane >= d) {
            ps = wadd(ps, vs);
            pi += vi;
        }
    }
    int es = __shfl_up_sync(FULL, ps, 1);
    int ei = __shfl_up_sync(FULL, pi, 1);
    if (lane == 0) es = ei = 0;
    // scores, and the running max: in the lane, then a warp max-scan of the
    // lanes' maxima, folded with the carry
    int sl[K], ml[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
        sl[i] = wadd(sc, wadd(es, ds[i]));
        ml[i] = i ? max(ml[i - 1], sl[i]) : sl[i];
    }
    int pm = ml[K - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, pm, d);
        if (lane >= d) pm = max(pm, v);
    }
    int em = __shfl_up_sync(FULL, pm, 1);
    em = lane ? max(rmc, em) : rmc;
    unsigned stop = bad;
#pragma unroll
    for (int i = 0; i < K; ++i)
        if (sl[i] <= wsub(max(em, ml[i]), xd)) stop |= 1u << i;
    // the steps before the window's first stop; the best among them and its
    // first argmax, in the lowest lane that holds it (al = -1 if none)
    const unsigned stop_lanes = __ballot_sync(FULL, stop != 0);
    const int first = stop_lanes ? __ffs(stop_lanes) - 1 : 32;
    const int n_alive = lane < first ? K : (lane == first ? __ffs(stop) - 1 : 0);
    int lb = INT_MIN, lid = 0, li = 0;
#pragma unroll
    for (int i = 0; i < K; ++i)
        if (i < n_alive && sl[i] > lb) {
            lb = sl[i];
            li = i;
            lid = di[i];
        }
    const int cm = __reduce_max_sync(FULL, lb);
    const int al = __ffs(__ballot_sync(FULL, n_alive > 0 && lb == cm)) - 1;
    const int step_at = __shfl_sync(FULL, K * lane + li, al & 31);
    const int id_at = __shfl_sync(FULL, ei + lid, al & 31);
    if (cm > bb) {  // ties keep the earlier step
        bb = cm;
        be = g0 + step_at + 1;
        bi = idc + id_at;
    }
    if (stop_lanes) return true;
    rmc = max(rmc, __shfl_sync(FULL, pm, 31));
    sc = wadd(sc, __shfl_sync(FULL, ps, 31));
    idc += __shfl_sync(FULL, pi, 31);
    return false;
}

__global__ void __launch_bounds__(32 * WARPS) ungapped_xdrop_kernel(Params p) {
    // per warp: the 32-bit offsets of step 0 (x, y) of the group's seeds,
    // and their masks of valid steps and matches (okm, eqm)
    __shared__ uint2 seed_at[WARPS][32], masks[WARPS][32];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
    const int warp = blockIdx.x * WARPS + wib;
    const int stride = gridDim.x * WARPS * 32;
    const int n = p.n, E = p.E, st = p.step;
    const int m = p.match, mm = p.mismatch, xd = p.x_drop;
    const int n_live = min(*p.n_live, n);
    const long long lane_off = (long long)st * lane;
    const int lane_st = (int)((unsigned)st * (unsigned)lane);

    for (int base = warp * 32; base < n; base += stride) {
        const int slot = base + lane;
        int ext = 0, best = 0, bid = 0;
        if (base < n_live && E > 0) {  // warp-uniform
            const bool act = slot < n_live && p.valid[slot];
            long long x0 = 0, y0 = 0;  // offsets of step 0
            bool inner = false;
            if (act) {
                x0 = (long long)p.px[slot] + p.base_off;
                y0 = (long long)p.py[slot] + p.base_off;
                inner = span_inside(x0, 31LL * st, p.lx) &&
                        span_inside(y0, 31LL * st, p.ly);
            }
            seed_at[wib][lane] = make_uint2((unsigned)x0, (unsigned)y0);
            __syncwarp();
            const unsigned actm = __ballot_sync(FULL, act);
            const unsigned innerm = __ballot_sync(FULL, inner);

            // this lane's seed: bit g of okm (eqm) says step g is valid (a
            // match), for g < 32. Seeds whose 32 steps lie inside both
            // sequences read unchecked at 32-bit offsets from lane l's step
            // l ...
            const uint8_t* cxl = p.cx + lane_st;
            const uint8_t* cyl = p.cy + lane_st;
            if (innerm == FULL)
                read_masks<true>(seed_at[wib], innerm, cxl, cyl, lane, masks[wib]);
            else
                read_masks<false>(seed_at[wib], innerm, cxl, cyl, lane, masks[wib]);
            // ... the others (near a sequence's end) read bounds-checked
            for (unsigned edge = actm & ~innerm; edge; edge &= edge - 1) {
                const int j = __ffs(edge) - 1;
                const int a = code_at(p.cx, p.lx, __shfl_sync(FULL, x0, j) + lane_off);
                const int c = code_at(p.cy, p.ly, __shfl_sync(FULL, y0, j) + lane_off);
                const unsigned okb = __ballot_sync(FULL, a < 5 && c < 5);
                const unsigned eqb = __ballot_sync(FULL, a == c && a < 4);
                if (lane == 0) masks[wib][j] = make_uint2(okb, eqb);
            }
            __syncwarp();
            const unsigned okm = masks[wib][lane].x, eqm = masks[wib][lane].y;
            __syncwarp();  // seed_at and masks are read; the next group rewrites them

            // Phase A: steps 0..31, a lane per seed. `run` holds the steps
            // before the first invalid one.
            const unsigned run = (~okm & (okm + 1)) - 1;
            int s = 0, rm = 0;
            bool live = true;
#pragma unroll
            for (int g = 0; g < 32; ++g) {
                s = wadd(s, (eqm >> g & 1) ? m : mm);
                rm = max(rm, s);
                live = live && (run >> g & 1) && s > wsub(rm, xd);
                if (live && s > best) {
                    best = s;
                    ext = g + 1;
                }
            }
            bid = ext ? __popc(eqm << (32 - ext)) : 0;

            // Phase B: a warp per seed still live after 32 steps. Most stop
            // within steps 32..63, one step a lane; past them, windows of
            // 32 * SPL steps, SPL a lane, each window's bytes read before
            // the previous window is decided.
            unsigned longm = E > 32 ? __ballot_sync(FULL, live) : 0u;
            const int id = __popc(eqm);
            while (longm) {
                const int j = __ffs(longm) - 1;
                longm &= longm - 1;
                int sc = __shfl_sync(FULL, s, j);
                int rmc = __shfl_sync(FULL, rm, j);
                int idc = __shfl_sync(FULL, id, j);
                int bb = __shfl_sync(FULL, best, j);
                int be = __shfl_sync(FULL, ext, j);
                int bi = __shfl_sync(FULL, bid, j);
                const long long xj = __shfl_sync(FULL, x0, j);
                const long long yj = __shfl_sync(FULL, y0, j);
                int a1[1], c1[1];
                read_window<1>(p, xj + (long long)st * (32 + lane),
                               yj + (long long)st * (32 + lane), true, a1, c1);
                if (!window<1>(a1, c1, 32, E, lane, m, mm, xd, sc, rmc, idc, bb,
                               be, bi) &&
                    E > 64) {
                    const long long win = (long long)st * SPL * 32;
                    long long gx = xj + (long long)st * (64 + SPL * lane);
                    long long gy = yj + (long long)st * (64 + SPL * lane);
                    int a[SPL], c[SPL];
                    read_window<SPL>(p, gx, gy, true, a, c);
                    for (int g0 = 64; g0 < E; g0 += 32 * SPL) {
                        gx += win;
                        gy += win;
                        int an[SPL], cn[SPL];
                        read_window<SPL>(p, gx, gy, g0 + 32 * SPL < E, an, cn);
                        if (window<SPL>(a, c, g0, E, lane, m, mm, xd, sc, rmc,
                                        idc, bb, be, bi))
                            break;
#pragma unroll
                        for (int i = 0; i < SPL; ++i) {
                            a[i] = an[i];
                            c[i] = cn[i];
                        }
                    }
                }
                if (lane == j) {
                    best = bb;
                    ext = be;
                    bid = bi;
                }
            }
        }
        if (slot < n) {
            p.out[slot] = ext;
            p.out[n + slot] = best;
            p.out[2 * n + slot] = bid;
        }
    }
}

// Blocks of a persistent grid on the current device: SMs x resident blocks
// -> the cudaError_t of the queries (0 = ok).
static int resident_blocks(int* blocks) {
    static int cached[64];  // by device ordinal; 0 = not asked yet
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64 && cached[dev]) {
        *blocks = cached[dev];
        return 0;
    }
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ungapped_xdrop_kernel, 32 * WARPS, 0);
    if (err != cudaSuccess) return (int)err;
    *blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) cached[dev] = *blocks;
    return 0;
}

extern "C" {

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers; n_live points to one int32 on the device.
// Every one of the n output slots is written. E must be a multiple of 32
// (cudaErrorInvalidValue otherwise), as the Pallas kernel requires.
int rk_ungapped_xdrop(const int* px, const int* py, const uint8_t* valid,
                      const uint8_t* cx, long long lx, const uint8_t* cy,
                      long long ly, const int* n_live, int n, int base_off,
                      int step, int match, int mismatch, int x_drop, int E,
                      int* out, void* stream) {
    Params p{px, py, valid, cx, cy, lx, ly, n_live, n, base_off, step,
             match, mismatch, x_drop, E, out};
    if (E < 0 || E % 32) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    int resident = 0;
    const int err = resident_blocks(&resident);
    if (err) return err;
    const int slots_per_block = 32 * WARPS;
    const int need = (n + slots_per_block - 1) / slots_per_block;
    ungapped_xdrop_kernel<<<need < resident ? need : resident, 32 * WARPS, 0,
                            (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

const char* rk_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
