"""A CUDA source of ``tiberate_tpu_torch/csrc`` built for the host by g++,
for the CPU tests of its kernels (``test_torch_modew.py``,
``test_torch_k6_sums.py``, ``test_torch_ffn.py``).

A shim ``cuda_runtime.h`` defines the CUDA qualifiers away and models
``__byte_perm``; each launch ``k<<<g, b, s, st>>>(args)`` is rewritten as
``tt_launch(g, b, s, st, k, args)``, which runs the grid's blocks in
turn; a block's shared memory is one static buffer; ``TT_BY_LOGN`` of the
real ``ntt.cuh`` is cut to the logN a test instantiates; ``TT_HOST`` is
defined, so that a source can put a plain C++ model in the place of an
instruction the host lacks (``matmul.cu``'s ``mma.sync``).  A block's
threads run in turn, or, with ``threads``, each as a thread of its own,
every ``__syncthreads`` a barrier of the whole block and every
``__syncwarp`` one of the thread's warp (kernels whose threads exchange
words through shared memory need that).
"""

import ctypes
import os
import re
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tiberate_tpu_torch", "csrc")

RUNTIME = r"""
#pragma once
#include <stddef.h>
#include <stdint.h>
#if TT_HOST_THREADS
#include <barrier>
#include <deque>
#include <thread>
#include <vector>
#endif
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
        : x(x_), y(y_), z(z_) {}
};
static dim3 blockIdx, gridDim, blockDim;
static thread_local dim3 threadIdx;
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
    return cudaSuccess;
}
struct alignas(16) longlong2 { long long x, y; };
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
// byte n of the result: byte (s >> 4 n) & 7 of y:x (x the low four)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const unsigned long long v = (unsigned long long)y << 32 | x;
    unsigned r = 0;
    for (int n = 0; n < 4; ++n)
        r |= (unsigned)(v >> (8 * ((s >> (4 * n)) & 7)) & 0xff) << (8 * n);
    return r;
}
inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz((unsigned)x); }
#if TT_HOST_THREADS
static std::barrier<>* tt_bar;
static std::deque<std::barrier<>>* tt_warp_bars;
inline void __syncthreads() { tt_bar->arrive_and_wait(); }
inline void __syncwarp() { (*tt_warp_bars)[threadIdx.x / 32].arrive_and_wait(); }
#else
inline void __syncthreads() {}
inline void __syncwarp() {}
#endif
template <class F, class... A>
void tt_launch(dim3 g, int b, int s, cudaStream_t st, F f, A... a) {
    gridDim = g;
    blockDim = dim3(b);
    for (unsigned z = 0; z < g.z; ++z)
        for (unsigned y = 0; y < g.y; ++y)
            for (unsigned x = 0; x < g.x; ++x) {
                blockIdx = dim3(x, y, z);
#if TT_HOST_THREADS
                std::barrier<> bar(b);
                tt_bar = &bar;
                std::deque<std::barrier<>> warps;
                for (int w = 0; 32 * w < b; ++w)
                    warps.emplace_back(b - 32 * w < 32 ? b - 32 * w : 32);
                tt_warp_bars = &warps;
                std::vector<std::thread> ts;
                for (int t = 0; t < b; ++t)
                    ts.emplace_back([=] {
                        threadIdx = dim3(t);
                        f(a...);
                    });
                for (auto& th : ts) th.join();
#else
                for (int t = 0; t < b; ++t) {
                    threadIdx = dim3(t);
                    f(a...);
                }
#endif
            }
}
"""


def build(tmp_dir, source, entries, logn, threads=False):
    """``csrc/<source>`` (with the real ``ntt.cuh`` and ``mont.cuh``) as a
    host library in ``tmp_dir``, ``TT_BY_LOGN`` cut to ``logn``; each C
    entry of ``entries`` ({name: argtypes}) typed to return int.  None
    where the host has no g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    d = str(tmp_dir)
    with open(os.path.join(CSRC, source)) as f:
        src = f.read()
    src = re.sub(r"([A-Za-z_]\w*(?:<[^;{}()]*?>)?)\s*<<<(.*?)>>>\s*\(",
                 lambda m: f"tt_launch({m.group(2)}, {m.group(1)}, ", src,
                 flags=re.S)
    src += "\nalignas(16) unsigned char tt_smem[1 << 18];\n"
    with open(os.path.join(CSRC, "ntt.cuh")) as f:
        cuh = f.read()
    cuh = re.sub(r"(\s*case (\d+): return FN<W, \d+>\(__VA_ARGS__\);"
                 r"\s*\\)",
                 lambda m: m.group(1) if int(m.group(2)) in logn else "", cuh)
    stem = os.path.splitext(source)[0]
    cpp = os.path.join(d, stem + "_host.cpp")
    for path, text in ((cpp, src), (os.path.join(d, "ntt.cuh"), cuh),
                       (os.path.join(d, "cuda_runtime.h"), RUNTIME)):
        with open(path, "w") as f:
            f.write(text)
    shutil.copy(os.path.join(CSRC, "mont.cuh"), os.path.join(d, "mont.cuh"))
    so = os.path.join(d, f"lib{stem}_host.so")
    subprocess.run([cxx, "-O1", "-std=c++20", "-shared", "-fPIC",
                    "-pthread", "-DTT_HOST=1",
                    f"-DTT_HOST_THREADS={int(threads)}", "-I", d,
                    "-o", so, cpp], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
