"""Decision settings the GPU solver reads.

The subset of the JAX package's ``DecisionConfig`` (field names and
defaults kept) that ``decision/gpu_solver.GpuSpfSolver`` honours.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DecisionConfig:
    # rfc5286 loop-free-alternate backup next hops (K3's LFA branch)
    enable_lfa: bool = False
    # on-device unreachable / saturation counts riding the pull buffers
    enable_numerical_sentinels: bool = True
    # seed each churn solve from the vantage's previous distance plane
    # and re-anchor only the affected cone (bit-identical to the cold
    # solve); the cone budget is this fraction of the area's node-lanes
    incremental_spf: bool = True
    incremental_cone_frac: float = 0.25
    # same-shape areas of one vantage with at most this many node slots
    # solve in one fused dispatch
    fuse_n_cap: int = 4096
    # an area whose padded node capacity exceeds this solves on the
    # multichip tier's mesh when it has two or more devices (by default
    # the visible cards); with one card, or a threshold <= 0, every
    # area solves on the one card
    multichip_n_cap_threshold: int = 131072
    # "bucketed" Δ-stepping (falls back to "sync" on plans with no
    # usable Δ) or "sync" rounds everywhere; both reach the same fixpoint
    spf_kernel: str = "bucketed"
    # streaming churn epochs: each incremental solve pulls a bucketed
    # changed-rows payload carrying the device route-ok bit, and the
    # vantage's two plane sets swap in place (implies incremental_spf)
    streaming_pipeline: bool = False

    def __post_init__(self):
        if not isinstance(self.streaming_pipeline, bool):
            raise ValueError(
                f"decision streaming_pipeline must be a bool, got "
                f"{self.streaming_pipeline!r}"
            )

    def solver_kwargs(self) -> dict:
        """Keyword arguments for ``GpuSpfSolver``."""
        return {
            "enable_lfa": self.enable_lfa,
            "enable_numerical_sentinels": self.enable_numerical_sentinels,
            "incremental_spf": self.incremental_spf,
            "incremental_cone_frac": self.incremental_cone_frac,
            "fuse_n_cap": self.fuse_n_cap,
            "multichip_n_cap_threshold": self.multichip_n_cap_threshold,
            "spf_kernel": self.spf_kernel,
            "streaming_pipeline": self.streaming_pipeline,
        }
