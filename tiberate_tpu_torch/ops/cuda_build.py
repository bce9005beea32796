"""Build and load the Hopper kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source into an object file (``tensor.cu``,
``keyswitch.cu``, ``glue.cu`` and ``matmul.cu`` once per lane, ``ntt.cu``
once per lane and direction, ``fold_probe.cu`` and ``csprng.cu`` once),
all at once in parallel processes, and links them into one shared library
with a plain C interface under ``tiberate_tpu_torch/_build/`` (named by a
hash of the sources, so an edited source is rebuilt); ``ctypes`` loads
it.  Nothing here runs at import time: a machine without ``nvcc`` or a
GPU imports the package and runs the plain torch versions on CPU
tensors.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("ntt.cu", "tensor.cu", "keyswitch.cu", "glue.cu", "fold_probe.cu",
           "csprng.cu", "matmul.cu")
HEADERS = ("mont.cuh", "ntt.cuh")
# (source, extra nvcc flags) per object file: ntt.cu, tensor.cu and
# keyswitch.cu instantiate their kernels for every logN, so each lane (and
# each direction of ntt.cu) builds apart; glue.cu's and matmul.cu's lanes
# build apart too
UNITS = (*(("ntt.cu", (f"-DTT_LANE={lane}", f"-DTT_FWD={fwd}"))
           for lane in (62, 30) for fwd in (1, 0)),
         *((src, (f"-DTT_LANE={lane}",))
           for src in ("tensor.cu", "keyswitch.cu", "glue.cu", "matmul.cu")
           for lane in (62, 30)),
         ("fold_probe.cu", ()), ("csprng.cu", ()))
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong

# The kernels of the cc_mult path: C entry point of the 62-bit lane ->
# argument types (pointers and the stream as void*); the 30-bit lane's entry
# point, the same name with "_30" appended, takes the same arguments.
_LANED = {
    "tt_ntt_fwd": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P],
    "tt_ntt_keymul_accum": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                            _I, _I, _P],
    "tt_ntt_inv": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P, _I,
                   _P],
    "tt_ntt_tensor": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                      _P, _P, _P],
    "tt_ntt_keymul_parts": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _P, _P, _P, _P, _I, _I, _P],
    # the step's glue (glue.cu): batch strides and round_at as long long
    "tt_rescale": [_P, _L, _P, _L, _P, _I, _I, _I, _P, _P, _P, _L, _I, _P],
    "tt_parts_digits": [_P, _L, _P, _I, _I, _I, _I, _P, _I, _P],
    "tt_pdiv_p0": [_P, _L, _P, _I, _I, _I, _P, _P, _P, _P],
    # the engine's elementwise ops (G4): op, then as the glue's
    "tt_modew": [_I, _P, _L, _P, _L, _P, _I, _I, _I, _P, _L, _P, _P, _P],
    # the stacked linear op (matmul.cu): x0, x1, feature stride, the weight
    # bytes, their limb and row strides, L, F_in, F_out, acc0, acc1, out0,
    # out1, C, N, q, k, 2^64 mod q, 2^124 mod q, stream
    "tt_matmul": [_P, _P, _L, _P, _L, _L, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                  _P, _P, _P, _P, _P],
}
# Every C entry point -> argument types.  The fold-rate probe takes its
# constants by value in its lane's word, and its Shoup fold has no 30-bit
# twin.
_SIGNATURES = {
    **{name + sfx: args for name, args in _LANED.items()
       for sfx in ("", "_30")},
    "tt_fold_shoup": [_P, _P, _L, _L, _L, _L, _I, _P],
    "tt_fold_redc": [_P, _P, _L, _L, _L, _L, _I, _P],
    "tt_fold_redc_30": [_P, _P, _L, _I, _I, _I, _I, _P],
    # the CSPRNG (csprng.cu, one lane): counter advances as unsigned int
    "tt_chacha_words": [_P, _I, _U, _P, _P],
    "tt_chacha_randint": [_P, _I, _I, _U, _U, _U, _I, _I, _P, _L, _P, _P],
    "tt_chacha_dgauss": [_P, _I, _I, _U, _U, _I, _U, _U, _P, _P, _I, _P,
                         _P],
    "tt_chacha_randround": [_P, _I, _I, _U, _U, _P, _P, _P],
}

_lib = None
build_log = ""


def cuda_tool(name: str):
    """The CUDA toolkit's program ``name`` (``nvcc``, ``cuobjdump``):
    ``$CUDA_HOME/bin/<name>``, else on the PATH, else under the toolkit's
    default install prefix; None if there is none."""
    homes = [os.environ.get(v) for v in ("CUDA_HOME", "CUDA_PATH")]
    for home in filter(None, homes):
        path = os.path.join(home, "bin", name)
        if os.path.exists(path):
            return path
    path = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    return path if os.path.exists(path) else None


def _nvcc():
    path = cuda_tool("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest():
    h = hashlib.sha256(ARCH.encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if needed; returns the library path.

    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and spills per
    kernel) and keeps the compiler's output in :data:`build_log`.
    """
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libtiberate_kernels_{_digest()}.so")
    if os.path.exists(lib_path) and not verbose:
        return lib_path
    tag = f"{os.getpid()}.tmp"  # concurrent builds
    # --split-compile=0: optimise a unit's kernels in parallel (each unit
    # but fold_probe.cu holds 28 unrolled kernels)
    flags = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "--split-compile=0"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    jobs = []
    for n, (src, extra) in enumerate(UNITS):
        obj = os.path.join(BUILD_DIR, f"{src}.{n}.{tag}.o")
        log = open(f"{obj}.log", "w+")
        cmd = [_nvcc(), *flags, *extra, "-c", "-o", obj,
               os.path.join(CSRC, src)]
        jobs.append((obj, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    logs, failed = [], []
    for obj, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(os.path.basename(obj))
        log.seek(0)
        logs.append(log.read())
        log.close()
        os.remove(log.name)
    objs = [obj for obj, _, _ in jobs]
    tmp_path = f"{lib_path}.{tag}"
    if not failed:
        proc = subprocess.run(
            [_nvcc(), ARCH, "-shared", "-o", tmp_path, *objs],
            capture_output=True, text=True,
        )
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append("link")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
    os.replace(tmp_path, lib_path)
    return lib_path


def sass(*parts):
    """SASS text (``cuobjdump -sass``) of the built library's kernels whose
    mangled names contain one of ``parts``; None without ``cuobjdump``.
    The names come from the symbol table: disassembling the whole library
    takes seconds per call."""
    tool = cuda_tool("cuobjdump")
    if tool is None:
        return None
    path = build()
    symbols = subprocess.run([tool, "-symbols", path], capture_output=True,
                             text=True, check=True).stdout
    names = sorted({n for n in re.findall(r"_Z\w+", symbols)
                    if any(p in n for p in parts)})
    if not names:
        return ""
    return subprocess.run([tool, "-sass", "-fun", ",".join(names), path],
                          capture_output=True, text=True, check=True).stdout


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib
