"""A checkout of the benchmark at a toy ring, for the CPU tests: a copy of
``fhebench/`` beside a ``BENCHMARK.json`` whose configurations are toy
prime chains (the program's ``toy_config``) with the real cells' mixes."""

import copy
import json
import os
import shutil

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

TOY = dict(logN=7, num_scales=10, num_special_primes=3, scale_bits=30)
TOY30 = dict(logN=7, num_scales=10, num_special_primes=2, scale_bits=21,
             buffer_bit_length=30)
LIMITS = {"residues": 0, "fresh": 1e-6, "mult": 1e-5, "sum": 2e-3,
          "key_noise": 31}


# the client round-trip cell, which BENCHMARK.json leaves out (its tail
# drifts between runs more than any bound allows): its entries, added as
# data where a test drives the "client" operation
CLIENT = {
    "workload": {"name": "logN15-client8", "config": "ckks-logN15",
                 "traffic": "client8", "chips": 1, "why": "client"},
    "end_to_end": {"name": "client_p95_ms", "unit": "ms", "better": "lower",
                   "bound": 0.25, "source": "host_clock",
                   "workloads": ["logN15-client8"]},
    "per_layer": [
        {"name": f"{m}.client", "unit": u, "better": "lower",
         "source": src, "layer": layer, "moves": "client_p95_ms",
         "workloads": ["logN15-client8"]}
        for m, u, src, layer in (
            ("device_idle_pct", "%", "device_trace", "Device"),
            ("encrypt_ms", "ms", "host_clock",
             "Engine API, CSPRNG and codec"),
            ("decrypt_ms", "ms", "host_clock",
             "Engine API, CSPRNG and codec"))],
}


def with_client(root, bench):
    """Add the client cell's entries to a checkout's BENCHMARK.json."""
    bench = copy.deepcopy(bench)
    bench["workloads"].append(CLIENT["workload"])
    bench["end_to_end"].append(CLIENT["end_to_end"])
    bench["per_layer"].extend(CLIENT["per_layer"])
    write(root, "BENCHMARK.json", bench)
    return bench


def toy_config(name, toy, limits=LIMITS):
    from tiberate_tpu_torch.config.toy import toy_config as make

    cfg = make(**toy)
    return {"name": name, "toy": toy, "logN": cfg.logN,
            "num_special_primes": cfg.num_special_primes,
            "scale_bits": cfg.scale_bits,
            "word_bits": cfg.buffer_bit_length,
            "primes": [int(q) for q in cfg.q], "limits": dict(limits)}


def make_root(tmp, configs=None, client=True):
    """A checkout under ``tmp``: the real BENCHMARK.json with every
    configuration file replaced by a toy one (``configs``: name -> config
    dict, default the TOY chain under each real name), and with
    ``client`` the client cell's entries."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(HERE, os.path.join(root, "fhebench"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        cfg = (configs or {}).get(c["name"]) or toy_config(c["name"], TOY)
        write(root, c["file"], cfg)
    write(root, "BENCHMARK.json", bench)
    if client:
        bench = with_client(root, bench)
    return root, copy.deepcopy(bench)


def write(root, rel, obj):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
