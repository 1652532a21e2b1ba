"""Epoch-seeded P x K identity sampling (a copy of
``centroids_reid_tpu/data/sampler.py``, which is numpy only; the port keeps
its own so that it imports nothing of the JAX package).

* each pid occurs ceil(len/K) times per epoch, with len reduced by one when
  len % K == 1 so no occurrence is left with a single sample;
* per epoch (seeded by the epoch number) draw P * G pids at a time without
  replacement from the pool of pids with remaining occurrences, until fewer
  than P * G remain;
* the pid sequence is split positionally into G chunks, one per group, so
  every group sees whole P-pid batches;
* each group consumes instances per pid without replacement from its own
  shuffled pool; when fewer than K remain, either resample with replacement
  from the pre-pop remainder (baseline) or pad with mock entries flagged
  not-real (CTL), mocks at the tail.

The plan is built on the host as static-shape integer arrays, and is the
JAX package's plan bit for bit for every epoch, G, P, K and resampling
flag (tests/test_torch_train_data.py). The port trains one group (G = 1).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np


class EpochPlan(NamedTuple):
    """Static-shape sampling plan for one epoch.

    pids:       [steps, G, P] int
    sample_idx: [steps, G, P, K] int  (indices into dataset.train)
    is_real:    [steps, G, P, K] bool (False for padded mocks)
    """

    pids: np.ndarray
    sample_idx: np.ndarray
    is_real: np.ndarray

    @property
    def num_steps(self) -> int:
        return self.pids.shape[0]


def occurrences_per_pid(n_samples: int, num_instances: int) -> int:
    n = n_samples
    if n % num_instances == 1:
        n -= 1
    return int(np.ceil(n / num_instances))


def max_steps_bound(
    train_dict, batch_pids: int, num_instances: int, num_groups: int
) -> int:
    """Upper bound on any epoch's step count: total pid occurrences can
    never pack into more than total // (P*G) steps."""
    total = sum(
        occurrences_per_pid(len(v), num_instances) for v in train_dict.values()
    )
    return total // (batch_pids * num_groups)


def build_epoch_plan(
    train_dict: Dict[int, list],
    batch_pids: int,
    num_instances: int,
    num_groups: int,
    epoch: int,
    use_resampling: bool,
) -> EpochPlan:
    p, k, g = batch_pids, num_instances, num_groups
    rng = np.random.RandomState(epoch)

    pids = sorted(train_dict)
    remaining = {
        pid: occurrences_per_pid(len(train_dict[pid]), k) for pid in pids
    }
    for pid in pids:
        if len(train_dict[pid]) <= 1:
            raise AssertionError(
                f"pid {pid} has <= 1 sample; cannot form P x K batches"
            )

    # -- pid sequence ------------------------------------------------------
    available = [pid for pid in pids if remaining[pid] > 0]
    sequence: List[int] = []
    while len(available) >= p * g:
        chosen = rng.choice(len(available), size=p * g, replace=False)
        # preserve draw order like random.sample
        for j in chosen:
            pid = available[j]
            sequence.append(pid)
            remaining[pid] -= 1
        available = [pid for pid in available if remaining[pid] > 0]

    total = len(sequence)
    assert total % (p * g) == 0, (
        f"sampler produced {total} pid draws, not divisible by P*G={p * g}"
    )
    steps = total // (p * g)
    if steps == 0:
        raise AssertionError(
            f"dataset too small for P={p} x G={g} identity batches"
        )

    # positional split into G rank-chunks, then steps within each chunk
    seq = np.asarray(sequence)
    chunks = seq.reshape(g, steps, p)  # chunk g, step t, slot p
    pid_plan = np.transpose(chunks, (1, 0, 2))  # [steps, G, P]

    # -- instance assignment (per-group pools) -----------------------------
    sample_idx = np.zeros((steps, g, p, k), np.int64)
    is_real = np.ones((steps, g, p, k), bool)

    # per-group shuffled pools of record indices
    pools = {}
    for gi in range(g):
        for pid in pids:
            recs = [r.idx for r in train_dict[pid]]
            pools[(gi, pid)] = list(rng.permutation(recs))

    for t in range(steps):
        for gi in range(g):
            for pi in range(p):
                pid = int(pid_plan[t, gi, pi])
                pool = pools[(gi, pid)]
                assert len(pool) > 1, (
                    f"pid {pid}: {len(pool)} samples remain (< 2)"
                )
                take = min(k, len(pool))
                picked = [pool.pop(0) for _ in range(take)]
                if take < k:
                    missing = k - take
                    if use_resampling:
                        extra = rng.choice(picked + pool, size=missing,
                                           replace=True)
                        picked.extend(int(e) for e in extra)
                    else:
                        # mock-padded: reuse last metadata, flag not real
                        is_real[t, gi, pi, take:] = False
                        picked.extend([picked[-1]] * missing)
                sample_idx[t, gi, pi] = picked

    return EpochPlan(pid_plan, sample_idx, is_real)
