"""The combine of the multichip tier: K23 ``shard_combine``.

The JAX package's multichip tier (``parallel/sharding.py``) joins the
members of a ('batch', 'graph') group with collectives: ``lax.pmin``
over 'graph' after each relaxation (sync) or each bucket epoch
(bucketed), and for the dirty slots' new weights; ``lax.pmax`` for the
incremental solve's parent plane; ``lax.psum`` over 'batch' for its
cone count. Here each member of a group holds its own copy of the
plane, and ``shard_combine`` leaves the elementwise min, max or sum of
all the copies in every one of them, as after the collective:

- members on one card (logical shards, the port's counterpart of the
  test suite's virtual CPU devices): one launch of K23
  (``csrc/combine.cu``), reading each copy once and writing each once;
- members each on its own card: NCCL's all-reduce (MIN, MAX or SUM) in
  this process (``torch.cuda.nccl``: one controller drives the mesh, as
  the reference's one process drives its devices, so there is no
  process group to join); a machine without NCCL raises;
- CPU tensors: the plain version, ``torch.minimum`` / ``torch.maximum``
  / ``torch.add`` folded over the copies (a sum wraps modulo 2^32, as
  the kernel's and psum's int32 add).

With ``ref`` and ``flag`` the combine also ORs 1 into ``flag`` where
the combined plane differs from ``ref`` (the plane the step read), so a
group's relaxation loop reads one change flag. ``shard_combine.launches``
counts K23's launches; ``shard_combine.nccl`` the NCCL all-reduces.
"""

from __future__ import annotations

import torch

from openr_tpu_torch.ops import cuda
from openr_tpu_torch.ops.relax import _is_cpu

# the members one K23 launch takes (csrc/combine.cu's MAX_MEMBERS)
MAX_MEMBERS = 16
# ncclRedOp_t
_NCCL_OPS = {"min": 3, "max": 2, "sum": 0}
# csrc/combine.cu's op codes
_OPS = {"min": 0, "max": 1, "sum": 2}


def shard_combine_plain(planes, op: str = "min", ref=None,
                        flag=None) -> None:
    fold = {"min": torch.minimum, "max": torch.maximum, "sum": torch.add}[op]
    v = planes[0].clone()
    for t in planes[1:]:
        v = fold(v, t.to(v.device))
    for t in planes:
        t.copy_(v)
    if ref is not None and flag is not None:
        flag |= (v != ref.to(v.device)).any().to(torch.int32).to(flag.device)


def shard_combine(planes, op: str = "min", ref=None, flag=None) -> None:
    """In place: every tensor of ``planes`` (equal shapes, int32, one per
    member of a mesh group) becomes the elementwise ``op`` ("min",
    "max" or "sum") of all of them. With ``ref`` (a plane of that shape on the
    first member's device) and ``flag`` (int32 [1] there), ORs 1 into
    ``flag`` where the result differs from ``ref``."""
    planes = list(planes)
    if op not in _NCCL_OPS:
        raise ValueError(f"unknown combine {op!r}")
    devices = {t.device for t in planes}
    if len(devices) > 1:
        _combine_cards(planes, op, ref, flag)
        return
    if _is_cpu(planes[0]):
        shard_combine_plain(planes, op, ref, flag)
        return
    if len(planes) > MAX_MEMBERS:
        raise ValueError(
            f"shard_combine: {len(planes)} members on one card (at most "
            f"{MAX_MEMBERS})")
    n = planes[0].numel()
    if any(t.numel() != n for t in planes):
        raise ValueError("shard_combine: planes differ in size")
    _launch(planes, n, op, ref, flag)


shard_combine.launches = 0
shard_combine.nccl = 0


def _launch(planes, n: int, op: str, ref, flag) -> None:
    cuda.launch("combine", "shard_combine", "aiLitt", planes, len(planes),
                n, _OPS[op], ref, flag)
    shard_combine.launches += 1


def _combine_cards(planes, op: str, ref, flag) -> None:
    """Members on distinct cards: NCCL's all-reduce in this process, then
    the change flag from the first member's copy (K23 over one plane)."""
    if len({t.device for t in planes}) != len(planes):
        raise ValueError(
            "a mesh group must lie on one card or on distinct cards")
    if any(t.device.type != "cuda" for t in planes):
        raise ValueError("a group across devices must be on CUDA cards")
    from torch.cuda import nccl

    if not nccl.is_available(planes):
        raise RuntimeError(
            "a mesh group across cards needs NCCL, which this PyTorch "
            "build cannot use for these tensors")
    nccl.all_reduce(planes, op=_NCCL_OPS[op])
    shard_combine.nccl += 1
    if ref is not None and flag is not None:
        _launch(planes[:1], planes[0].numel(), op, ref, flag)
