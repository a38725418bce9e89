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
group's relaxation loop reads one change flag.

``shard_combine_groups`` combines every group of a call whose members
share a card in one launch of K23 (at most ``MAX_GROUPS`` a launch), and
with ``also`` a second set of groups (the whole-fabric step's per-root
change stamps, by max) in the same launch; a group across cards is one
NCCL all-reduce as before. ``shard_combine`` is the one-group call,
through the same C entry. ``shard_combine.launches`` counts K23's
launches by either; ``shard_combine.nccl`` the NCCL all-reduces.
"""

from __future__ import annotations

import torch

from openr_tpu_torch.ops import cuda

# the members and groups one K23 launch takes (csrc/combine.cu's
# MAX_MEMBERS, MAX_GROUPS)
MAX_MEMBERS = 16
MAX_GROUPS = 8
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


def shard_combine_groups_plain(groups, op: str = "min", refs=None,
                               flags=None, also=None,
                               also_op: str = "max") -> None:
    for i, planes in enumerate(groups):
        shard_combine_plain(planes, op, None if refs is None else refs[i],
                            None if flags is None else flags[i])
    for planes in also or ():
        shard_combine_plain(planes, also_op)


def shard_combine(planes, op: str = "min", ref=None, flag=None) -> None:
    """In place: every tensor of ``planes`` (equal shapes, int32, one per
    member of a mesh group) becomes the elementwise ``op`` ("min",
    "max" or "sum") of all of them. With ``ref`` (a plane of that shape on the
    first member's device) and ``flag`` (int32 [1] there), ORs 1 into
    ``flag`` where the result differs from ``ref``."""
    shard_combine_groups((planes,), op, None if ref is None else (ref,),
                         None if flag is None else (flag,))


def shard_combine_groups(groups, op: str = "min", refs=None, flags=None,
                         also=None, also_op: str = "max") -> None:
    """``shard_combine`` of every group of ``groups`` (a list of member
    plane lists), with ``refs`` / ``flags`` one a group (or None); and,
    with ``also`` (a list of as many member lists, group i's beside group
    i's planes), every group of ``also`` combined by ``also_op``. On the
    card the groups whose members (and ``also`` members) share a card
    are one K23 launch there (``MAX_GROUPS`` groups a launch); a group
    across cards is NCCL's all-reduce. Groups share no tensor."""
    if op not in _NCCL_OPS or also_op not in _NCCL_OPS:
        raise ValueError(f"unknown combine {op!r} / {also_op!r}")
    if also is not None and len(also) != len(groups):
        raise ValueError("shard_combine: one also group a group")
    if not groups:
        return
    lead = groups[0][0]
    if lead.is_cuda and len(groups) <= MAX_GROUPS:
        # the relaxation loops' case: every group on one card, one launch
        card = lead.get_device()
        if all(t.get_device() == card for p in groups for t in p) and (
                also is None or all(t.get_device() == card
                                    for p in also for t in p)):
            _launch(groups, op, refs, flags, also, also_op)
            return
    groups = [list(p) for p in groups]
    also = None if also is None else [list(p) for p in also]
    by_card: dict = {}
    for i, planes in enumerate(groups):
        devices = {t.device for t in planes}
        if also is not None:
            devices |= {t.device for t in also[i]}
        if len(devices) > 1:
            _combine_cards(planes, op, _at(refs, i), _at(flags, i))
            if also is not None:
                _combine_cards(also[i], also_op, None, None)
        else:
            by_card.setdefault(devices.pop(), []).append(i)
    for dev, idx in by_card.items():
        sub = [groups[i] for i in idx]
        sub_refs = None if refs is None else [refs[i] for i in idx]
        sub_flags = None if flags is None else [flags[i] for i in idx]
        sub_also = None if also is None else [also[i] for i in idx]
        if dev.type == "cpu":
            shard_combine_groups_plain(sub, op, sub_refs, sub_flags, sub_also,
                                       also_op)
            continue
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        for k in range(0, len(sub), MAX_GROUPS):
            s = slice(k, k + MAX_GROUPS)
            _launch(sub[s], op, _at(sub_refs, s), _at(sub_flags, s),
                    _at(sub_also, s), also_op)


shard_combine.launches = 0
shard_combine.nccl = 0


def _at(seq, i):
    return None if seq is None else seq[i]


def _width(groups) -> tuple:
    """(members a group, words a plane) of equal-shaped groups."""
    g, n = len(groups[0]), groups[0][0].numel()
    if g > MAX_MEMBERS:
        raise ValueError(f"shard_combine: {g} members on one card (at most "
                         f"{MAX_MEMBERS})")
    for p in groups:
        if len(p) != g:
            raise ValueError("shard_combine: groups differ in members")
        for t in p:
            if t.numel() != n:
                raise ValueError("shard_combine: planes differ in size")
    return g, n


def _launch(groups, op: str, refs, flags, also, also_op: str) -> None:
    """One K23 launch: the members, then a ref and a flag a group, then
    the also groups' members, in one pointer array."""
    g, n = _width(groups)
    seq = [t for p in groups for t in p]
    with_ref = refs is not None and flags is not None
    if with_ref:  # (a ref without a flag sets nothing)
        if len(refs) != len(groups) or len(flags) != len(groups):
            raise ValueError("shard_combine: one ref and flag a group")
        for r in refs:
            if r.numel() != n:
                raise ValueError("shard_combine: a ref of the planes' size")
        seq += refs
        seq += flags
    n_also = 0
    if also is not None:
        ga, n_also = _width(also)
        if ga != g:
            raise ValueError("shard_combine: also groups differ in members")
        seq += [t for p in also for t in p]
    cuda.launch("combine", "shard_combine", "aiiLiiiLi", seq, len(groups),
                g, n, _OPS[op], int(with_ref), int(also is not None), n_also,
                _OPS[also_op])
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
        _launch([planes[:1]], op, [ref], [flag], None, "max")
