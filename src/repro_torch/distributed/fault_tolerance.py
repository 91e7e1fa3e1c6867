"""Fault tolerance, elasticity and straggler mitigation
(``repro.distributed.fault_tolerance``).

  * ``run_with_restarts`` — the supervision loop: run the train function;
    on failure restore the latest checkpoint and continue.  The port's
    train state is updated in place, so by the time a fault fires the
    caller's initial state holds the last finished step (and a fault
    inside a step may leave some leaves updated and others not): a restart
    overwrites every leaf from the checkpoint, and with no checkpoint yet
    starts again from a fresh initial state, never the mutated one.
  * ``ElasticPlan`` — on device loss, the largest ("data", "model") mesh
    the surviving devices hold, keeping the model-parallel degree;
    checkpoints are mesh-agnostic, so ``Checkpointer.restore(...,
    shardings=mesh)`` puts the state onto it.
  * ``StragglerPolicy`` — EMA step-time detection and a deterministic
    shard-to-host assignment (numpy).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.optim.optimizers import tree_leaves


class FaultInjector:
    """Deterministic fault schedule for tests: raise at given steps."""

    def __init__(self, fail_at: Sequence[int] = ()):  # steps that die once
        self.fail_at = set(fail_at)
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


def run_with_restarts(
    train_fn: Callable[[int, Any], Tuple[Any, int]],
    ckpt: Checkpointer,
    init_state: Any,
    *,
    max_restarts: int = 3,
    start: int = 0,
) -> Tuple[Any, int, int]:
    """Supervise ``train_fn(start_step, state) -> (state, next_step)``,
    starting at ``start`` (a resumed run's restored step).

    ``init_state`` is the state to start from, or a zero-argument callable
    that builds it.  On an exception: join the checkpointer's pending
    write, then restore the latest checkpoint into the state in place
    (every leaf) and go on from its step; with no checkpoint yet, start
    again at step 0 from a fresh state, the callable's (the old state is
    dropped first, so no second copy is held) or, for a state passed as
    such, a host copy taken on entry when the directory held no
    checkpoint.  Gives up (re-raises) after ``max_restarts``.
    Returns (state, final_step, restarts_used)."""
    build = init_state if callable(init_state) else None
    state = build() if build else init_state
    pristine = None
    if build is None and ckpt.latest_step() is None:
        pristine = [t.detach().to("cpu", copy=True)
                    for t in tree_leaves(state)]
    restarts, step = 0, start
    while True:
        try:
            state, step = train_fn(step, state)
            return state, step, restarts
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
        ckpt.wait()
        latest = ckpt.latest_step()
        if latest is not None:
            ckpt.restore(latest, state)
            step = latest
            continue
        step = 0
        if build:
            state = None
            state = build()
        else:
            with torch.no_grad():
                for t, h in zip(tree_leaves(state), pristine):
                    t.copy_(h)


@dataclasses.dataclass
class ElasticPlan:
    """Re-mesh plan after losing devices.

    Keeps the TP degree (model axis) intact — TP re-sharding would change
    per-op layouts — and shrinks the data axis to the largest multiple
    that fits, dropping stragglers/failed hosts.
    """

    n_devices: int
    model_parallel: int

    def viable(self) -> bool:
        return self.n_devices >= self.model_parallel

    @property
    def data_parallel(self) -> int:
        return self.n_devices // self.model_parallel

    @property
    def devices_used(self) -> int:
        return self.data_parallel * self.model_parallel

    def global_batch_for(self, per_replica_batch: int) -> int:
        return self.data_parallel * per_replica_batch

    def make_mesh(self, device: str | torch.device = "cuda"):
        """The ("data", "model") mesh over ``devices_used`` ranks
        (``launch.mesh.make_mesh_for``)."""
        from repro_torch.launch.mesh import make_mesh_for

        return make_mesh_for(self.devices_used, self.model_parallel,
                             device=device)


def plan_after_failure(
    total_devices: int, lost: int, model_parallel: int
) -> ElasticPlan:
    return ElasticPlan(total_devices - lost, model_parallel)


@dataclasses.dataclass
class StragglerPolicy:
    """EMA-based detection + deterministic shard reassignment."""

    n_hosts: int
    ema_alpha: float = 0.3
    threshold: float = 2.0

    def __post_init__(self):
        self.ema = np.zeros(self.n_hosts)

    def observe(self, host_times: Sequence[float]) -> List[int]:
        t = np.asarray(host_times, dtype=np.float64)
        self.ema = np.where(
            self.ema == 0, t, self.ema_alpha * t + (1 - self.ema_alpha) * self.ema
        )
        med = float(np.median(self.ema))
        return [i for i in range(self.n_hosts) if self.ema[i] > self.threshold * med]

    def assignment(self, step: int, exclude: Sequence[int] = ()) -> Dict[int, int]:
        """shard index -> host id for this step (deterministic permutation,
        skipping excluded hosts; excluded hosts' shards go to the fastest)."""
        alive = [h for h in range(self.n_hosts) if h not in set(exclude)]
        rng = np.random.default_rng(step)
        perm = rng.permutation(len(alive))
        return {
            shard: alive[perm[shard % len(alive)]]
            for shard in range(self.n_hosts)
        }
