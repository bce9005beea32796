"""RNS prime partitioning: the key-switch decomposition and sharding plan.

Behavioral equivalent of the reference ``tiberate/context/rns_partition.py``:

* ordinary (non-base) primes are grouped into ``ceil((P-1)/S)`` contiguous
  *partitions* of ``num_special_primes`` primes each — these are the
  key-switching decomposition parts,
* the base message prime forms its own partition, the special primes another,
* partitions are round-robined across shards (devices) in reverse order so
  rescaling (which drops primes from the global front) unloads shards evenly,
* per-level views describe which prime indices remain where.

A copy of ``tiberate_tpu/context/rns_partition.py``.  The port runs the
single-shard (num_devices=1) plan, in which case at level ``lvl`` the live
prime indices are simply ``[lvl .. P+S-1]``.
"""

import numpy as np


class RnsPartition:
    def __init__(
        self, num_ordinary_primes=17, num_special_primes=2, num_devices=1
    ):
        P = num_ordinary_primes
        S = num_special_primes
        D = num_devices

        num_partitions = -(-(P - 1) // S)

        # Contiguous groups of S ordinary primes, then base, then specials.
        partitions = [
            list(range(i * S, min((i + 1) * S, P - 1)))
            for i in range(num_partitions)
        ]
        partitions.append([P - 1])
        partitions.append(list(range(P, P + S)))

        # Round-robin parts over devices, reversed so that the *last* parts
        # (largest prime indices, dropped last by rescaling) sit on device 0.
        def alloc(i):
            return list(range(num_partitions - i - 1, -1, -D))[::-1]

        part_allocations = [alloc(i) for i in range(D)]
        part_allocations[0].append(num_partitions)  # base partition -> dev 0
        for p in part_allocations:
            p.append(num_partitions + 1)  # specials everywhere

        prime_allocations = [
            [partitions[part] for part in part_allocations[i]] for i in range(D)
        ]
        flat_prime_allocations = [
            [idx for part in palloc for idx in part]
            for palloc in prime_allocations
        ]

        self.num_ordinary_primes = P
        self.num_special_primes = S
        self.num_devices = D
        self.num_partitions = num_partitions
        self.partitions = partitions
        self.part_allocations = part_allocations
        self.prime_allocations = prime_allocations
        self.flat_prime_allocations = flat_prime_allocations
        self.num_scales = P - 1
        self.base_prime_idx = P - 1

        self.compute_destination_arrays()
        self.compute_rescaler_locations()
        self.compute_partitions()

    # ------------------------------------------------------------------
    # Per-level prime placement.
    # ------------------------------------------------------------------

    def compute_destination_arrays(self):
        self.destination_arrays_with_special = [
            [
                [a for a in self.flat_prime_allocations[d] if a >= lvl]
                for d in range(self.num_devices)
            ]
            for lvl in range(self.num_ordinary_primes)
        ]

        self.destination_arrays = []
        for lvl in range(self.num_ordinary_primes):
            no_special = [
                a[: -self.num_special_primes]
                for a in self.destination_arrays_with_special[lvl]
            ]
            self.destination_arrays.append([a for a in no_special if a])

    def compute_rescaler_locations(self):
        # The shard owning the globally smallest live prime index rescales.
        self.rescaler_loc = [
            int(np.argmin([min(a) for a in arrs]))
            for arrs in self.destination_arrays_with_special
        ]

    # ------------------------------------------------------------------
    # Per-level part layout (local index ranges into the level's array).
    # ------------------------------------------------------------------

    def partings(self, lvl):
        part_counts = [
            np.array([len(p) for p in palloc])
            for palloc in self.prime_allocations
        ]
        part_cumsums = [np.cumsum(c) for c in part_counts]
        level_diffs = [
            len(a) - len(b)
            for a, b in zip(
                self.destination_arrays_with_special[0],
                self.destination_arrays_with_special[lvl],
            )
        ]
        part_cumsums_lvl = [
            [int(a) for a in (cs - d) if a > 0]
            for cs, d in zip(part_cumsums, level_diffs)
        ]
        part_count_lvl = [
            np.diff(a, prepend=0) for a in part_cumsums_lvl
        ]
        parts_lvl = [
            [list(range(a, b)) for a, b in zip([0] + cs[:-1], cs)]
            for cs in part_cumsums_lvl
        ]
        return part_cumsums_lvl, part_count_lvl, parts_lvl

    def compute_partitions(self):
        self.part_cumsums = []
        self.part_counts = []
        self.parts = []
        self.destination_parts = []
        self.destination_parts_with_special = []
        self.p = []
        self.p_special = []
        self.diff = []

        self.d = [
            self.destination_arrays[0][d] for d in range(self.num_devices)
        ]
        self.d_special = [
            self.destination_arrays_with_special[0][d]
            for d in range(self.num_devices)
        ]

        for lvl in range(self.num_ordinary_primes):
            pcu, pco, par = self.partings(lvl)
            self.part_cumsums.append(pcu)
            self.part_counts.append(pco)
            self.parts.append(par)

            dest = self.destination_arrays_with_special[lvl]
            destp_special = [
                [[d[pi] for pi in p] for p in dev_p]
                for d, dev_p in zip(dest, par)
            ]
            destp = [dev_dp[:-1] for dev_dp in destp_special]
            self.destination_parts.append(destp)
            self.destination_parts_with_special.append(destp_special)

            diff = [
                len(d1) - len(d2)
                for d1, d2 in zip(
                    self.destination_arrays_with_special[0],
                    self.destination_arrays_with_special[lvl],
                )
            ]
            p_special = [
                [[pi + d for pi in p] for p in dev_p]
                for d, dev_p in zip(diff, par)
            ]
            p = [dev_p[:-1] for dev_p in p_special]
            self.p.append(p)
            self.p_special.append(p_special)
            self.diff.append(diff)
