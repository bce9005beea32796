"""NTT-friendly prime mining.

Reproduces the reference's prime-search behavior
(``tiberate/utils/generate_primes.py``):

* message/special primes: mined downward as odd candidates from ``2^mbits - 1``
  with the NTT-friendliness constraint ``q ≡ 1 (mod 2N)``
  (reference ``generate_primes.py:118-157``),
* scale primes: mined alternating above/below ``2^scale_bits`` with the
  quadratic-deviation-guided search window so cumulative scale drift cancels
  (reference ``generate_primes.py:179-268``).

Primality is decided with a *deterministic* Miller-Rabin witness set valid for
all 64-bit integers (the reference uses random witnesses; same accept set with
overwhelming probability, deterministic here by construction).

Results are cached as JSON (the reference caches pickles it never ships; first
import mines them).  Mining is fast enough in pure Python that no native helper
is needed: candidates are stepped in units of 2N.
"""

import json
import os
from functools import lru_cache

CACHE_FOLDER = os.environ.get(
    "TIBERATE_TORCH_PRIME_CACHE", os.path.dirname(__file__)
)

# Deterministic Miller-Rabin witnesses covering all n < 3.3e24 (> 2^64).
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)

DEFAULT_LOGN_RANGE = tuple(range(12, 18))  # logN 12..17 inclusive


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for 64-bit integers."""
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def check_ntt_primality(q: int, M: int) -> bool:
    """Is q prime and of the KM+1 form (q ≡ 1 mod M, M = 2N)?"""
    return (q - 1) % M == 0 and is_prime(q)


def find_the_next_prime(start: int, m: int, up: bool = True) -> int:
    """First NTT prime at or beyond ``start`` stepping in the given direction.

    Steps directly between candidates ≡ 1 (mod m) instead of the reference's
    odd-by-odd walk; the set of accepted primes is identical.
    """
    if up:
        q = start + ((1 - start) % m)  # smallest q >= start with q % m == 1
    else:
        q = start - ((start - 1) % m)  # largest q <= start with q % m == 1
    step = m if up else -m
    while not (q > m and is_prime(q)):
        q += step
        if q <= 1:
            raise RuntimeError("prime search ran below 1")
    return q


def generate_message_primes_for(mbits: int, logN: int, how_many: int = 11):
    """Message/special primes: descending from 2^mbits - 1, q ≡ 1 mod 2N."""
    m = 2 ** (logN + 1)
    primes = []
    q = 2**mbits - 1
    while len(primes) < how_many:
        q = find_the_next_prime(q, m, up=False)
        primes.append(q)
        q -= 2
    return primes


def generate_alternating_prime_sequence(
    sb: int = 40, N: int = 2**15, how_many: int = 60, optimize: bool = True
):
    """Scale primes alternating above/below 2^sb.

    Follows the reference's pre-rescale quadratic-deviation rule
    (``generate_primes.py:179-268``): after each pick the cumulative relative
    scale ``c`` progresses as ``c <- c^2 * (2^sb / p)^2`` and, when optimizing,
    the opposite-direction search start is advanced to the deviation-cancelling
    candidate.
    """
    m = N * 2
    scale = 2**sb
    s_primes = []

    up = scale + 1
    down = scale - 1

    up0 = find_the_next_prime(up, m, up=True)
    down0 = find_the_next_prime(down, m, up=False)
    eup = up0 - scale
    edown = scale - down0
    # Next direction is the opposite of whichever first pick is closer.
    current_direction = not (eup < edown)

    cumulative_scale = 1.0
    while len(s_primes) < how_many:
        start = up if current_direction else down
        next_prime = find_the_next_prime(start, m, up=current_direction)

        current_dev = scale / next_prime
        cumulative_scale = cumulative_scale**2 * current_dev**2

        if current_direction:
            up = next_prime + 2
            if optimize:
                searched = int((cumulative_scale * scale) // 2 * 2 - 1)
                down = min(down, searched)
        else:
            down = next_prime - 2
            if optimize:
                searched = int((cumulative_scale * scale) // 2 * 2 + 1)
                up = max(up, searched)

        current_direction = not current_direction
        s_primes.append(next_prime)

    return s_primes


def _pgen_pseq(sb: int, N: int, how_many: int):
    """Mine a sequence, halving the request on failure; None if impossible.

    (The reference returns an error string for infeasible (sb, N) combos,
    e.g. sb=20 at logN=17 where primes ≡ 1 mod 2N near 2^20 run out;
    we record the combo as absent instead.)
    """
    if how_many < 2:
        return None
    try:
        return generate_alternating_prime_sequence(
            sb=sb, N=N, how_many=how_many
        )
    except Exception:
        return _pgen_pseq(sb, N, how_many // 2)


def _cache_path(name: str) -> str:
    return os.path.join(CACHE_FOLDER, name)


@lru_cache(maxsize=1)
def generate_message_primes(mbits=(28, 60), how_many: int = 11):
    """{mbits: {N: [primes]}} over the default logN range, JSON-cached."""
    path = _cache_path("message_special_primes.json")
    if os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        return {
            int(mb): {int(n): v for n, v in d.items()} for mb, d in raw.items()
        }

    mprimes = {}
    for mb in mbits:
        mprimes[mb] = {}
        for logN in DEFAULT_LOGN_RANGE:
            N = 2**logN
            mprimes[mb][N] = generate_message_primes_for(mb, logN, how_many)

    with open(path, "w") as f:
        json.dump(mprimes, f)
    return mprimes


@lru_cache(maxsize=1)
def generate_scale_primes():
    """{(scale_bits, N): [primes]} for scale_bits in 20..50 step 5, JSON-cached.

    how_many = 64 for logN < 16, 128 otherwise (reference
    ``generate_primes.py:305-315``).
    """
    path = _cache_path("scale_primes.json")
    if os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
        out = {}
        for key, v in raw.items():
            sb, n = key.split(",")
            out[(int(sb), int(n))] = v
        return out

    result = {}
    for logN in DEFAULT_LOGN_RANGE:
        N = 2**logN
        how_many = 64 if logN < 16 else 128
        for sb in range(20, 55, 5):
            seq = _pgen_pseq(sb, N, how_many)
            if seq is not None:
                result[(sb, N)] = seq

    with open(path, "w") as f:
        json.dump({f"{sb},{n}": v for (sb, n), v in result.items()}, f)
    return result
