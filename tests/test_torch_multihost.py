"""Two processes over gloo on the CPU: ``parallel/multihost.py``.

The port's counterpart of ``tests/test_parallel.py::
test_multihost_two_process``.  Each process runs the same program with
jax blocked: ``init_multihost``; an
engine on its (batch, rns 2) share of the global mesh from one seed; the
same-seed keys equal across the processes; ``broadcast_key`` of an evk
only rank 0 holds; ``scatter_batch`` of its own two ciphertext pairs; and
one mesh step with the broadcast key.  The parent holds each process's
public key and step outputs to the JAX engine's single-process bytes
(same seed and draw order; the step on the process's inputs).
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np

from tiberate_tpu.config.toy import toy_config
from tiberate_tpu.engine import CkksEngine as JaxEngine
from tiberate_tpu.parallel import sharded as jsharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
sys.modules["jax"] = None
import numpy as np, torch, torch.distributed as dist
from tiberate_tpu_torch.config.toy import toy_config
from tiberate_tpu_torch.engine import CkksEngine
from tiberate_tpu_torch.parallel import multihost as mh, sharded
from tiberate_tpu_torch.typing import EvaluationKey

rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \\
    sys.argv[4]
assert mh.init_multihost(num_processes=1) == (0, 1)     # a no-op
assert mh.init_multihost(f"localhost:{port}", world, rank) == (rank, world)
mesh = mh.global_mesh(rns=2, devices=["cpu"] * 2)
assert mesh.shape == {"batch": world, "rns": 2, "coef": 1}
cfg = toy_config(logN=7, num_scales=4, num_special_primes=2, scale_bits=30)
eng = CkksEngine(cfg, seed=11, nonce=3, mesh=mesh)
sk, pk, evk = eng.sk, eng.pk, eng.evk       # the JAX engine's draw order

# 1. same-seed keys are the same bytes in every process
pk0 = pk.data[0].gather()
got = [torch.empty_like(pk0) for _ in range(world)]
dist.all_gather(got, pk0)
assert all(torch.equal(g, pk0) for g in got), "same-seed keys differ"

# 2. an evk only rank 0 holds reaches every process
real = [tuple(k.gather() for k in part) for part in evk.data]
held = real if rank == 0 else [tuple(torch.zeros_like(k) for k in part)
                               for part in real]
bcast = mh.broadcast_key(held, from_process=0, device="cpu")
assert all(torch.equal(x, y) for p, r in zip(bcast, real)
           for x, y in zip(p, r))
bkey = EvaluationKey(data=tuple(bcast), flags=evk._flags, level=0,
                     **evk.misc)

# 3. this process's batch onto the global mesh, one step with that key
rng = np.random.default_rng(100 + rank)
cts = eng.encodecrypt_batch([rng.uniform(-1, 1, eng.num_slots)
                             for _ in range(4)])
rows = [tuple(d.gather() for d in ct.data) for ct in cts]
a0, a1 = mh.scatter_batch(rows[:2], mesh)
b0, b1 = mh.scatter_batch(rows[2:], mesh)
assert a0.shape[0] == 2 * world and a0.spec[0] == "batch"
step = sharded.make_mult_step(eng, 0)
mesh.reset_counts()
o0, o1 = step(a0, a1, b0, b1, sharded.prepare_step_ksk(eng, 0, ksk=bkey),
              sharded.mult_step_params(eng, 0, ksk=bkey))
assert mesh.counts["all_gather"] == 1, mesh.counts
np.savez(out, pk0=pk0.numpy(),
         **{f"in{i}": np.stack([r[i % 2] for r in rows[2 * (i // 2):
                                                      2 * (i // 2) + 2]])
            for i in range(4)},
         o0=mh.local_batch(o0).numpy(), o1=mh.local_batch(o1).numpy())
dist.destroy_process_group()
print(f"multihost OK {rank}/{world}")
"""


def test_two_processes_over_gloo(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = [str(tmp_path / f"rank{i}.npz") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(i), "2", str(port), outs[i]],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for i, (p, (out, err)) in enumerate(zip(procs, res)):
        assert p.returncode == 0, f"rank {i}: {err[-3000:]}"
        assert f"multihost OK {i}/2" in out

    jeng = JaxEngine(toy_config(logN=7, num_scales=4, num_special_primes=2,
                                scale_bits=30), seed=11, nonce=3)
    jeng.sk, jeng.pk, jeng.evk               # the children's draw order
    jstep = jax.jit(jsharded.make_mult_step(jeng, 0))
    jksk = jsharded.prepare_step_ksk(jeng, 0)
    jprm = jsharded.mult_step_params(jeng, 0)
    for path in outs:
        z = np.load(path)
        assert np.array_equal(z["pk0"], np.asarray(jeng.pk.data[0]))
        for b in range(2):
            want = jstep(*(z[f"in{i}"][b] for i in range(4)), jksk, jprm)
            assert np.array_equal(z["o0"][b], np.asarray(want[0]))
            assert np.array_equal(z["o1"][b], np.asarray(want[1]))
