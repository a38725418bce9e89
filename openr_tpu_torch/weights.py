"""Carry the JAX solver's device inputs across to the port.

The system has no weights: what a solve reads from the device is the
resident mirror, the packed announcer matrix, the root tables and the
previous solve's outputs. ``from_jax_state`` converts those arrays, as
numpy arrays in the JAX pipeline's argument order, into the port's
tensors, so a test can feed the same device inputs to both pipelines.
"""

from __future__ import annotations

import numpy as np
import torch

from openr_tpu_torch.decision.gpu_solver import resolve_device

# the JAX pipeline's positional arguments, in order
JAX_ARGS = (
    "deltas", "shift_w", "res_rows", "res_nbr", "res_w", "mbuf",
    "root", "root_nbr", "root_w",
    "prev_metric", "prev_s3w", "prev_nhw",
    "prev_lfa_slot", "prev_lfa_metric",
)


def from_jax_state(args, device="cuda") -> dict:
    """``args``: the JAX pipeline's inputs as numpy arrays (or anything
    ``np.asarray`` takes), in ``JAX_ARGS`` order. Returns the keyword
    arguments of ``gpu_solver.pipeline``: int32 tensors on ``device``
    and ``root`` as an int. The LFA passthrough planes are dropped (the
    port's pipeline runs without LFA)."""
    if len(args) != len(JAX_ARGS):
        raise ValueError(f"expected {len(JAX_ARGS)} arrays, got {len(args)}")
    dev = resolve_device(device)
    out = {}
    for name, arr in zip(JAX_ARGS, args):
        if name.startswith("prev_lfa"):
            continue
        a = np.asarray(arr)
        if name == "root":
            out[name] = int(a)
        else:
            out[name] = torch.tensor(
                np.ascontiguousarray(a, dtype=np.int32), device=dev
            )
    return out
