"""Data-flow planner, single-device subset (paper §3.1).

The reference scores REPLICATE / PARTITION / GATHER per op on a device
mesh.  On one device there is nothing to shard: every op's weights live
whole on the card and no strategy moves bytes, so the plan is REPLICATE
for every op — what the reference's planner gives on a 1x1 mesh.  The
multi-device layouts wait for the port's multi-device slice.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field


class Strategy(str, enum.Enum):
    REPLICATE = "replicate"
    PARTITION = "partition"
    GATHER = "gather"

    def __str__(self) -> str:  # pragma: no cover
        return self.value


@dataclass(frozen=True)
class MeshSpec:
    """Logical device mesh: axis name -> size."""
    axis_sizes: dict
    batch_axes: tuple = ("data",)
    tp_axis: str = "model"

    @property
    def n_devices(self) -> int:
        return math.prod(self.axis_sizes.values())


SINGLE_DEVICE = MeshSpec(axis_sizes={"data": 1, "model": 1})


@dataclass(frozen=True)
class OpSpec:
    """A weight-bearing logical op (one entry per layer-class).

    roles: proj_in, proj_out, embed, lm_head, expert_in/out, state.
    """
    name: str
    weight_shape: tuple
    role: str
    n_layers: int = 1
    dtype_bytes: int = 2
    act_in_features: int = 0
    act_out_features: int = 0
    flops_per_token: float = 0.0
    top_k: int = 0


@dataclass(frozen=True)
class OpPlan:
    op: OpSpec
    strategy: Strategy


@dataclass
class DataflowPlan:
    mesh: MeshSpec
    kind: str
    ops: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)

    def __getitem__(self, name: str) -> OpPlan:
        return self.ops[name]


def plan_model(ops: list, mesh: MeshSpec, *, kind: str) -> DataflowPlan:
    """Plan every op on a single device: REPLICATE throughout."""
    if mesh.n_devices != 1:
        raise NotImplementedError(
            f"the port plans one device; got mesh {mesh.axis_sizes}")
    plan = DataflowPlan(mesh=mesh, kind=kind)
    for op in ops:
        plan.ops[op.name] = OpPlan(op=op, strategy=Strategy.REPLICATE)
    return plan
