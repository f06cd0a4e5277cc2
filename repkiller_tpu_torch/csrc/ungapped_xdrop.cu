// Ungapped x-drop seed extension, one direction, for Hopper (sm_90a). Kernel
// K2 of the port.
//
// Replaces repkiller_tpu/extend/ungapped_pallas.py `_make_kernel` (launched
// from `_direction`). Semantics: repkiller_tpu_torch/extend/ungapped.py
// `direction_plain`, which the tests hold against the Pallas kernel, the XLA
// `extend/ungapped._direction` and oracle.pipeline._directional_gain; this
// file must agree with it exactly on every output.
//
// Design: one thread per seed, blocks of 128 threads. A thread walks its
// seed's diagonal one step at a time, g = 0 .. E-1, at x = px + base_off +
// step*g (and the same for y), reading the bases straight from the uint8
// code arrays with bounds checks:
//   - a step is valid when both positions lie in the sequences, their codes
//     are < 5 and the seed is valid; N (code 4) is valid but never a match;
//   - s += match or mismatch; idents += match; rm = max(rm, max(s, 0));
//   - the thread stops BEFORE using step g when g is invalid or
//     s <= rm - x_drop;
//   - otherwise s > best (strict: ties keep the earlier step) records
//     best = s, ext = g + 1 and the identities so far.
// The state starts at zero, so a seed that never gains gives (0, 0, 0). The
// TPU kernel's 32-row chunks and log-step scans are not carried over: a
// thread runs the scan sequentially and exits at its first stop.
//
// Bound: latency of dependent byte loads and warp divergence. Most seeds
// stop within ~10 steps, while seeds in repeats run up to E = 2048 steps, and
// a warp runs as long as its longest seed. Packed 2-bit reads and regrouping
// long seeds are later work.

#include <cuda_runtime.h>
#include <stdint.h>

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

__global__ void __launch_bounds__(128) ungapped_xdrop_kernel(Params p) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= p.n) return;
    int ext = 0, best = 0, bid = 0;
    if (s < *p.n_live && p.valid[s]) {
        long long x = (long long)p.px[s] + p.base_off;
        long long y = (long long)p.py[s] + p.base_off;
        int sc = 0, rm = 0, id = 0;
        for (int g = 0; g < p.E; ++g, x += p.step, y += p.step) {
            if (x < 0 || x >= p.lx || y < 0 || y >= p.ly) break;
            const int a = p.cx[x], c = p.cy[y];
            if (a >= 5 || c >= 5) break;
            const bool eq = a == c && a < 4;
            sc += eq ? p.match : p.mismatch;
            id += eq ? 1 : 0;
            rm = max(rm, max(sc, 0));
            if (sc <= rm - p.x_drop) break;
            if (sc > best) {
                best = sc;
                ext = g + 1;
                bid = id;
            }
        }
    }
    p.out[s] = ext;
    p.out[p.n + s] = best;
    p.out[2 * p.n + s] = bid;
}

extern "C" {

// Launches K2 on `stream`; returns the cudaError_t of the launch (0 = ok).
// All pointers are device pointers; n_live points to one int32 on the device.
int rk_ungapped_xdrop(const int* px, const int* py, const uint8_t* valid,
                      const uint8_t* cx, long long lx, const uint8_t* cy,
                      long long ly, const int* n_live, int n, int base_off,
                      int step, int match, int mismatch, int x_drop, int E,
                      int* out, void* stream) {
    Params p{px, py, valid, cx, cy, lx, ly, n_live, n, base_off, step,
             match, mismatch, x_drop, E, out};
    if (n <= 0) return 0;
    const int threads = 128;
    ungapped_xdrop_kernel<<<(n + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

const char* rk_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
