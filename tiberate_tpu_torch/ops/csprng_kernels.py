"""The ChaCha20 CSPRNG as Hopper kernels (R1-R4): wrappers and plain versions.

Each draw of :class:`~tiberate_tpu_torch.rng.csprng.Csprng` is one launch
of a kernel of ``csrc/csprng.cu`` that runs the block function, samples
and steps the drawn rows' counters:

====  =======================  =============================================
R1    :func:`chacha_words`     the keystream words (``randbytes``)
R2    :func:`chacha_randint`   uniform ``(u128 q_c) >> 128 + shift``
R3    :func:`chacha_dgauss`    the discrete Gaussian (CDT inversion)
R4    :func:`chacha_randround` stochastic rounding of f64 coefficients
====  =======================  =============================================

:func:`encrypt_noise` is ``encrypt_noise_batch``'s draw pair for B
messages: one R2 and one R3 launch in their batch forms.

Every wrapper takes the generator's ``states`` ([rows, 16] int64,
contiguous, each word below 2^32) and a row range, and advances the
range's block counters in place, as the plain versions do.  The plain
versions are the functions of :mod:`tiberate_tpu_torch.rng` (the block
function, the counter step and the samplers), composed as ``Csprng`` ran
them before the kernels.  As in :mod:`~tiberate_tpu_torch.ops.ntt_kernels`:
the operands are checked first; then a CPU tensor runs the plain version,
a CUDA tensor launches the kernel or raises, any other device raises;
every launch adds one to ``ntt_kernels.LAUNCHES`` under the kernel's name
(the CSPRNG has one lane).  The kernels' samples and counters are
bit-identical to the plain versions'.
"""

import torch

from tiberate_tpu_torch.ops import cuda_build
from tiberate_tpu_torch.ops import ntt_kernels as kern
from tiberate_tpu_torch.ops.ntt_kernels import _done, _on_cpu, _ptr, _stream
from tiberate_tpu_torch.rng import csprng as rc
from tiberate_tpu_torch.rng.chacha20 import M32, chacha20_block, step_counter

WRAPPERS = ("chacha_words", "chacha_randint", "chacha_dgauss",
            "encrypt_noise", "chacha_randround")
KERNELS = ("chacha_words", "chacha_randint", "chacha_dgauss",
           "chacha_randround")
LAUNCHES = kern.LAUNCHES
LAUNCHES.update(dict.fromkeys(KERNELS, 0))

_I64 = torch.int64
_ROW_BYTES = 16 * 8
_MAX_DEPTH = 8     # TT_RNG_MAXDEPTH: the deepest CDT tree the kernel takes
_MAX_ROWS = (1 << 31) - 1


# ----------------------------------------------------------------------
# Checks and launches.
# ----------------------------------------------------------------------


def _state_rows(states, r0, r1):
    """The row count of ``states[r0:r1]``; raises on anything the kernels
    do not take."""
    if states.dtype != _I64:
        raise TypeError(f"states have dtype {states.dtype}, expected "
                        f"torch.int64")
    if states.dim() != 2 or states.shape[1] != 16:
        raise ValueError(f"states must be [rows, 16], got "
                         f"{tuple(states.shape)}")
    if not states.is_contiguous():
        raise ValueError("states must be contiguous")
    if not 0 <= r0 <= r1 <= states.shape[0]:
        raise ValueError(f"rows [{r0}, {r1}) lie outside the "
                         f"{states.shape[0]} state rows")
    if r1 - r0 > _MAX_ROWS:
        raise ValueError(f"{r1 - r0} rows in one launch")
    return r1 - r0


def _check_u32(**values):
    """Counter advances: the kernels add them as uint32."""
    for name, v in values.items():
        if not 0 <= v <= M32:
            raise OverflowError(f"{name} = {v} is no 32-bit counter step")


def _check_aux(states, dtype, **tensors):
    for name, t in tensors.items():
        if t.device != states.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{states.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _row_ptr(states, r0):
    if states.data_ptr() % 16:
        raise ValueError("states must be 16-byte aligned")
    return states.data_ptr() + r0 * _ROW_BYTES


def _launch(name, *args):
    """Call the C entry point ``tt_<name>``; raise on a failed launch,
    count a good one (``ntt_kernels._done``)."""
    _done(getattr(cuda_build.lib(), "tt_" + name)(*args), name)


# (device, values) -> a device tensor of them: the q chains and the
# noise modulus of every draw, copied to the device once (a copy from
# pageable host memory waits for the work queued on the stream)
_TABLES = {}
_TABLES_MAX = 64


def device_table(values, device):
    """``values`` (ints below 2^63) as an int64 tensor on ``device``,
    built once and cached."""
    key = (torch.device(device), tuple(values))
    hit = _TABLES.get(key)
    if hit is None:
        if len(_TABLES) >= _TABLES_MAX:
            _TABLES.clear()
        hit = _TABLES[key] = torch.tensor(key[1], dtype=_I64, device=device)
    return hit


# ----------------------------------------------------------------------
# R1 — keystream words.
# ----------------------------------------------------------------------


def chacha_words_plain(states, r0, r1, step):
    target = states[r0:r1]
    words = chacha20_block(target)
    states[r0:r1] = step_counter(target, step)
    return words


def chacha_words(states, r0, r1, step):
    """The keystream blocks of state rows [r0, r1) ([rows, 16] int64
    words); their counters advance by ``step``."""
    rows = _state_rows(states, r0, r1)
    _check_u32(step=step)
    if _on_cpu(states):
        return chacha_words_plain(states, r0, r1, step)
    out = torch.empty((rows, 16), dtype=_I64, device=states.device)
    if rows:
        _launch("chacha_words", _row_ptr(states, r0), rows, step, _ptr(out),
                _stream(states.device))
    return out


# ----------------------------------------------------------------------
# R2 — uniform integers.
# ----------------------------------------------------------------------


def chacha_randint_plain(states, r0, r1, q, shift, step):
    words = chacha_words_plain(states, r0, r1, step)
    L = (r1 - r0) // q.numel()
    return rc._randint_from_words(words, q.repeat_interleave(L), int(shift))


def _check_q(states, q, rows):
    _check_aux(states, _I64, q=q)
    if q.dim() != 1 or q.numel() < 1 or rows % q.numel():
        raise ValueError(f"q of shape {tuple(q.shape)}: one modulus a "
                         f"channel of the {rows} rows")


def chacha_randint(states, r0, r1, q, shift, step):
    """Four uniform samples a row of [r0, r1) ([rows, 4] int64): in
    [shift, q_c + shift), q_c = ``q[c]`` (int64, below 2^63) for the rows
    of channel c, the rows split into ``q.numel()`` channels; the
    counters advance by ``step``."""
    rows = _state_rows(states, r0, r1)
    _check_u32(step=step)
    _check_q(states, q, rows)
    if _on_cpu(states):
        return chacha_randint_plain(states, r0, r1, q, shift, step)
    out = torch.empty((rows, 4), dtype=_I64, device=states.device)
    if rows:
        _launch("chacha_randint", _row_ptr(states, r0), rows, 1, 0, 0, step,
                1, rows // q.numel(), _ptr(q), int(shift), _ptr(out),
                _stream(states.device))
    return out


# ----------------------------------------------------------------------
# R3 — the discrete Gaussian.
# ----------------------------------------------------------------------


def chacha_dgauss_plain(states, r0, r1, tree_lo, tree_hi, depth, step):
    words = chacha_words_plain(states, r0, r1, step)
    return rc._dgauss_from_words(words, tree_lo, tree_hi, depth)


def _check_tree(states, tree_lo, tree_hi, depth):
    _check_aux(states, _I64, tree_lo=tree_lo, tree_hi=tree_hi)
    if not 1 <= depth <= _MAX_DEPTH:
        raise ValueError(f"tree depth {depth}: the kernel takes 1 to "
                         f"{_MAX_DEPTH}")
    nodes = (1 << depth) - 1
    if tree_lo.shape != (nodes,) or tree_hi.shape != (nodes,):
        raise ValueError(f"a depth-{depth} tree has {nodes} nodes; got "
                         f"{tuple(tree_lo.shape)}, {tuple(tree_hi.shape)}")


def chacha_dgauss(states, r0, r1, tree_lo, tree_hi, depth, step):
    """Four discrete-Gaussian samples a row of [r0, r1) ([rows, 4] int64)
    by CDT inversion over the tree's low and high halves (int64 bit
    patterns, [2^depth - 1] each); the counters advance by ``step``."""
    rows = _state_rows(states, r0, r1)
    _check_u32(step=step)
    _check_tree(states, tree_lo, tree_hi, depth)
    if _on_cpu(states):
        return chacha_dgauss_plain(states, r0, r1, tree_lo, tree_hi, depth,
                                   step)
    out = torch.empty((rows, 4), dtype=_I64, device=states.device)
    if rows:
        _launch("chacha_dgauss", _row_ptr(states, r0), rows, 1, 0, 0, rows,
                step, step, _ptr(tree_lo), _ptr(tree_hi), depth, _ptr(out),
                _stream(states.device))
    return out


# ----------------------------------------------------------------------
# R2 + R3 — encrypt_noise_batch's draws.
# ----------------------------------------------------------------------


def encrypt_noise_plain(states, r0, L, tree_lo, tree_hi, depth, amax, B,
                        inc):
    t, u = slice(r0, r0 + L), slice(r0 + L, r0 + 2 * L)
    e, v, states[t], states[u] = rc._encrypt_noise_core(
        states[t], states[u], tree_lo, tree_hi, int(amax), B=B, depth=depth,
        inc=inc)
    return e.reshape(B, 2, 4 * L), v.reshape(B, 4 * L)


def encrypt_noise(states, r0, L, tree_lo, tree_hi, depth, amax, B, inc):
    """The noise of B encryptions from the two repeating channels at rows
    r0 (t) and r0 + L (u): ``(e [B, 2, 4L], v [B, 4L])``, the bytes of B
    sequential draw pairs (``discrete_gaussian(repeats=2)``, ``randint(
    amax, repeats=1)[0]``).  Message k reads channel t at counter advances
    2k inc (e0) and (2k + 1) inc (v), channel u at k inc (e1); t then
    advances by 2B inc, u by B inc.  On the card: R2 (v, reading t
    without writing it), then R3 (e, stepping both channels)."""
    rows = _state_rows(states, r0, r0 + 2 * L)
    if B < 1 or L < 1:
        raise ValueError(f"B = {B}, L = {L}: both must be positive")
    if 2 * B * inc > M32:
        raise OverflowError(f"2 * B * inc = {2 * B * inc} exceeds the "
                            f"32-bit counter step")
    _check_tree(states, tree_lo, tree_hi, depth)
    if _on_cpu(states):
        return encrypt_noise_plain(states, r0, L, tree_lo, tree_hi, depth,
                                   amax, B, inc)
    dev = states.device
    q = device_table([int(amax)], dev)
    v = torch.empty((B, L, 4), dtype=_I64, device=dev)
    e = torch.empty((B, rows, 4), dtype=_I64, device=dev)
    ptr, stream = _row_ptr(states, r0), _stream(dev)
    _launch("chacha_randint", ptr, L, B, inc, 2 * inc, 0, 0, L, _ptr(q), 0,
            _ptr(v), stream)
    _launch("chacha_dgauss", ptr, rows, B, 2 * inc, inc, L, 2 * B * inc,
            B * inc, _ptr(tree_lo), _ptr(tree_hi), depth, _ptr(e), stream)
    return e.reshape(B, 2, 4 * L), v.reshape(B, 4 * L)


# ----------------------------------------------------------------------
# R4 — stochastic rounding.
# ----------------------------------------------------------------------


def chacha_randround_plain(states, r0, coefs, inc):
    B, M = coefs.shape
    rows = M // 16
    base = states[r0:r0 + rows]
    ks = torch.arange(B, dtype=_I64, device=states.device)[:, None]
    words = chacha20_block(step_counter(base, ks * inc))
    states[r0:r0 + rows] = step_counter(base, B * inc)
    return rc._randround_core(coefs.reshape(-1), words).reshape(B, -1)


def chacha_randround(states, r0, coefs, inc):
    """Stochastically round ``coefs`` [B, 16 rows] (f64) to int64 against
    the words of state rows [r0, r0 + rows): coefficient 16 r + j of
    message k against word j of row r at counter advance k inc; the
    counters then advance by B inc."""
    if coefs.dim() != 2 or coefs.shape[1] % 16:
        raise ValueError(f"coefs must be [B, 16 rows], got "
                         f"{tuple(coefs.shape)}")
    B = coefs.shape[0]
    rows = _state_rows(states, r0, r0 + coefs.shape[1] // 16)
    _check_u32(step=B * inc)
    _check_aux(states, torch.float64, coefs=coefs)
    if _on_cpu(states):
        return chacha_randround_plain(states, r0, coefs, inc)
    out = torch.empty(coefs.shape, dtype=_I64, device=states.device)
    if rows and B:
        _launch("chacha_randround", _row_ptr(states, r0), rows, B, inc,
                B * inc, _ptr(coefs), _ptr(out), _stream(states.device))
    return out

