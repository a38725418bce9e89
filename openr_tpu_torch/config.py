"""Decision settings the GPU solver reads.

The subset of the JAX package's ``DecisionConfig`` (field names and
defaults kept) that ``decision/gpu_solver.GpuSpfSolver`` honours.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class DecisionConfig:
    # rfc5286 loop-free-alternate backup next hops; the GPU solver
    # refuses True until LFA is ported
    enable_lfa: bool = False
    # on-device unreachable / saturation counts riding the pull buffers
    enable_numerical_sentinels: bool = True
    # areas whose padded node capacity exceeds this need the multichip
    # tier, which the GPU solver refuses until it is ported
    multichip_n_cap_threshold: int = 131072
    # "bucketed" Δ-stepping (falls back to "sync" on plans with no
    # usable Δ) or "sync" rounds everywhere; both reach the same fixpoint
    spf_kernel: str = "bucketed"

    def solver_kwargs(self) -> dict:
        """Keyword arguments for ``GpuSpfSolver``."""
        return {
            "enable_lfa": self.enable_lfa,
            "enable_numerical_sentinels": self.enable_numerical_sentinels,
            "multichip_n_cap_threshold": self.multichip_n_cap_threshold,
            "spf_kernel": self.spf_kernel,
        }
