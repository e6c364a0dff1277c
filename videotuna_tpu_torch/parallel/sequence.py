"""Sequence parallelism of the port, the counterpart of
``videotuna_tpu/parallel/sequence.py``: Ulysses all-to-all and ring
attention over the process groups of the mesh's axes.

- Ulysses: two ``all_to_all_single`` calls reshard (B, S/n, H, D) blocks to
  (B, S, H/n, D) and back around the full attention of H/n heads, the
  port's ``flash_attention`` (K1/K2) or, under autograd,
  ``flash_attention_diff`` (K1/K5 forward, K7/K8 backward).  Its backward
  reshards the cotangent the same way and runs the local attention's
  backward.
- Ring: each rank attends its query block to the resident key/value block
  with ``flash_fwd(..., emit_lse=True, route="K5")`` (its plain version on
  the CPU), merges the hops' (o, LSE) pairs in f32 by logaddexp, and passes
  the key/value block one hop on (an ``all_to_all_single`` with one
  non-empty split, which NCCL, gloo and a threaded group all carry),
  started before the hop's kernel so that the copy overlaps it.  The
  backward runs ``flash_bwd`` (K8 at d = 128) on each hop with the global
  output and LSE: dq accumulates at home, dk and dv ride the ring with their
  block and arrive home after the full circle.
- Hybrid: Ulysses over one axis around the ring over another.

The ``*_local`` functions take this rank's blocks and the axes' process
groups.  ``sp_attention`` is the wrapper with the JAX package's contract:
global (B, S, H, D) tensors on every rank in, the global output out, each
rank computing its block of the batch (over ``batch_axes``, when the batch
divides) and of the sequence; under autograd the gradients of q, k and v
are the global ones on every rank.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from videotuna_tpu_torch.kernels import attention as A

_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _default_attn_fn(q, k, v, scale: Optional[float] = None):
    """The local attention of Ulysses: the port's flash attention, with
    its backward kernels under autograd."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return A.flash_attention_diff(q, k, v, False, scale)
    return A.flash_attention(q, k, v, scale=scale)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...): block j goes to rank j; block j of the result came from
    rank j."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _rotate(x: torch.Tensor, group, async_op: bool = False):
    """Send x whole to the next rank of ``group`` and receive the previous
    rank's (JAX's ``ppermute`` with perm i → i+1).  Returns (the received
    tensor, the work handle or None)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    sends, recvs = [0] * n, [0] * n
    sends[(r + 1) % n] = x.shape[0]
    recvs[(r - 1) % n] = x.shape[0]
    out = torch.empty_like(x)
    work = dist.all_to_all_single(out, x.contiguous(), recvs, sends,
                                  group=group, async_op=async_op)
    return out, work


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + tuple(xt.shape[1:]))
    _gather_single(out, xt, group=group)
    return out.movedim(0, dim)


# ---------------------------------------------------------------------------
# Ulysses: sequence-sharded → head-sharded resharding around attention
# ---------------------------------------------------------------------------

def _a2a_seq_to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    # (B, S/n, H, D) → (B, S, H/n, D): head group j goes to rank j, and
    # rank i's sequence block lands at position i
    b, s_l, h, d = x.shape
    xs = x.reshape(b, s_l, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    out = _all_to_all(xs, group)
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * s_l, h // n, d)


def _a2a_heads_to_seq(x: torch.Tensor, group, n: int) -> torch.Tensor:
    # (B, S, H/n, D) → (B, S/n, H, D).  The received rank index must land
    # BEFORE the local-head index (head = src_rank·h_l + local) to invert
    # _a2a_seq_to_heads' split; the other order permutes heads whenever
    # h_l > 1
    b, s, h_l, d = x.shape
    xs = x.reshape(b, n, s // n, h_l, d).permute(1, 0, 2, 3, 4).contiguous()
    out = _all_to_all(xs, group)
    return out.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h_l, d)


class _UlyssesCore(torch.autograd.Function):
    """JAX ``_ulysses_core``'s custom VJP: the cotangent reshards like the
    primal, and the local attention's backward runs on the saved
    head-sharded graph."""

    @staticmethod
    def forward(ctx, q, k, v, group, attn_fn):
        n = dist.get_world_size(group)
        leaves = [_a2a_seq_to_heads(t, group, n).requires_grad_()
                  for t in (q, k, v)]
        with torch.enable_grad():
            out = attn_fn(*leaves)
        ctx.group, ctx.n = group, n
        ctx.leaves, ctx.out = leaves, out
        return _a2a_heads_to_seq(out.detach(), group, n)

    @staticmethod
    def backward(ctx, g):
        g_g = _a2a_seq_to_heads(g.contiguous(), ctx.group, ctx.n)
        grads = torch.autograd.grad(ctx.out, ctx.leaves, g_g)
        ctx.leaves = ctx.out = None
        return tuple(_a2a_heads_to_seq(d, ctx.group, ctx.n)
                     for d in grads) + (None, None)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, group,
                            attn_fn: Optional[Callable] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: this rank's (B, S/n, H, D) blocks.  All-to-all to
    (B, S, H/n, D), full attention on the local heads, reshard back."""
    attn_fn = attn_fn or functools.partial(_default_attn_fn, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _UlyssesCore.apply(q, k, v, group, attn_fn)
    n = dist.get_world_size(group)
    qg, kg, vg = (_a2a_seq_to_heads(t, group, n) for t in (q, k, v))
    return _a2a_heads_to_seq(attn_fn(qg, kg, vg), group, n)


# ---------------------------------------------------------------------------
# Ring attention: key/value rotation with the LSE merge
# ---------------------------------------------------------------------------

def _hop_attention(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                   scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop: q against the resident key/value block → the normalised
    output (f32, (B, Sq, H, D)) and the natural-log LSE (f32, (B, Sq, H)).
    K5 on a CUDA tensor, its plain version on the CPU."""
    o, lse = A.flash_fwd(q, k_blk, v_blk, sm_scale=scale, emit_lse=True,
                         route="K5")
    return o.float(), lse.transpose(1, 2)


def _hop_backward(q, k_blk, v_blk, out, lse, g, scale):
    """The gradients of one key/value block's part given the GLOBAL output
    and LSE (B, H, Sq): p = exp(s − lse) is the true probability restricted
    to the block, so the flash backward gives the block's dq, dk, dv."""
    return A.flash_bwd(q, k_blk, v_blk, out, g, lse, sm_scale=scale)


def merge_hop(acc: Optional[torch.Tensor], lse_run: Optional[torch.Tensor],
              o_p: torch.Tensor, lse_p: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a hop's (o, LSE) into the running pair, in f32 by logaddexp
    (the first hop's pair is taken as it is)."""
    if acc is None:
        return o_p, lse_p
    lse_new = torch.logaddexp(lse_run, lse_p)
    acc = (acc * torch.exp(lse_run - lse_new)[..., None]
           + o_p * torch.exp(lse_p - lse_new)[..., None])
    return acc, lse_new


def _ring_forward(q, k, v, group, scale):
    n = dist.get_world_size(group)
    acc = lse_run = None
    kv = torch.stack((k, v))
    for i in range(n):
        nxt = work = None
        if i < n - 1:   # the next hop's block travels during this hop
            nxt, work = _rotate(kv, group, async_op=True)
        acc, lse_run = merge_hop(acc, lse_run,
                                 *_hop_attention(q, kv[0], kv[1], scale))
        if work is not None:
            work.wait()
            kv = nxt
    return acc.to(q.dtype), lse_run


def _ring_backward(q, k, v, out, lse, g, group, scale):
    n = dist.get_world_size(group)
    lse_t = lse.transpose(1, 2).contiguous()       # (B, H, Sq)
    g = g.contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dkv = torch.zeros((2,) + tuple(k.shape), dtype=torch.float32,
                      device=k.device)
    kv = torch.stack((k, v))
    for i in range(n):
        nxt = work = None
        if i < n - 1:
            nxt, work = _rotate(kv, group, async_op=True)
        dq_h, dk_h, dv_h = _hop_backward(q, kv[0], kv[1], out, lse_t, g,
                                         scale)
        dq += dq_h.float()
        dkv[0] += dk_h.float()
        dkv[1] += dv_h.float()
        # the block's gradients follow it; after n moves they are home
        dkv, _ = _rotate(dkv, group)
        if work is not None:
            work.wait()
            kv = nxt
    return dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """JAX ``ring_attention_local``'s custom VJP: the fused ring backward,
    neither pass materialising (Sq, Sk)."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        out, lse = _ring_forward(q, k, v, group, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return _ring_backward(q, k, v, out, lse, g, ctx.group,
                              ctx.scale) + (None, None)


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group, scale: Optional[float] = None
                         ) -> torch.Tensor:
    """q, k, v: this rank's (B, S/n, H, D) blocks of the sequence; the
    result equals full non-causal attention over S, this rank's block."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, group, scale)
    return _ring_forward(q, k, v, group, scale)[0]


def hybrid_sp_attention_local(q, k, v, ulysses_group, ring_group,
                              scale: Optional[float] = None):
    """Ulysses over heads × ring over the sequence (xfuser's hybrid):
    all-to-all over the Ulysses group so each rank owns H/u heads of the
    ring-sharded sequence, ring attention over the ring group, reshard
    back."""
    return ulysses_attention_local(
        q, k, v, ulysses_group,
        attn_fn=lambda qq, kk, vv: ring_attention_local(qq, kk, vv,
                                                        ring_group, scale))


# ---------------------------------------------------------------------------
# User-facing wrapper: global tensors in, global tensors out
# ---------------------------------------------------------------------------

Blocks = Sequence[Tuple[int, Sequence[str]]]   # (tensor dim, mesh axes)


def _split(x: torch.Tensor, mesh, blocks: Blocks) -> torch.Tensor:
    for dim, axes in blocks:
        n = mesh.extent(*axes)
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(*axes) * size, size)
    return x.contiguous()


def _gather(x: torch.Tensor, mesh, blocks: Blocks) -> torch.Tensor:
    for dim, axes in reversed(blocks):
        for axis in reversed(axes):     # the minor axis first
            x = _all_gather(x, dim, mesh.group(axis))
    return x


class _Split(torch.autograd.Function):
    """This rank's block of a replicated tensor; the gradient of the whole
    is gathered from every rank's block."""

    @staticmethod
    def forward(ctx, x, mesh, blocks):
        ctx.mesh, ctx.blocks = mesh, blocks
        return _split(x, mesh, blocks)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.mesh, ctx.blocks), None, None


class _Gather(torch.autograd.Function):
    """The whole tensor from every rank's block; the gradient of a block is
    its part of the (replicated) gradient of the whole."""

    @staticmethod
    def forward(ctx, x, mesh, blocks):
        ctx.mesh, ctx.blocks = mesh, blocks
        return _gather(x, mesh, blocks)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.mesh, ctx.blocks), None, None


def sp_attention(mesh, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 ulysses_axis: Optional[str] = "sp",
                 ring_axis: Optional[str] = None,
                 batch_axes: Tuple[str, ...] = ("dp", "fsdp"),
                 scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention with the sequence dimension split over the
    mesh's ``ulysses_axis`` and/or ``ring_axis`` (hybrid when both) and the
    batch over ``batch_axes`` (where it divides; otherwise every rank
    computes the whole batch).  q, k, v: the GLOBAL (B, S, H, D) tensors,
    the same on every rank; returns the global output."""
    ug = mesh.group(ulysses_axis) if ulysses_axis else None
    rg = mesh.group(ring_axis) if ring_axis else None
    seq_axes = tuple(a for a, g in ((ulysses_axis, ug), (ring_axis, rg))
                     if g is not None)
    if not seq_axes:
        return _default_attn_fn(q, k, v, scale)
    n = mesh.extent(*seq_axes)
    if q.shape[1] % n or k.shape[1] != q.shape[1]:
        raise ValueError(f"sequence {q.shape[1]} (keys {k.shape[1]}) does "
                         f"not split over {seq_axes} = {n}")
    if ug is not None and q.shape[2] % mesh.extent(ulysses_axis):
        raise ValueError(f"{q.shape[2]} heads do not split over "
                         f"{ulysses_axis} = {mesh.extent(ulysses_axis)}")
    blocks = []
    b_axes = tuple(a for a in batch_axes if mesh.shape.get(a, 1) > 1)
    if b_axes and q.shape[0] % mesh.extent(*b_axes) == 0:
        blocks.append((0, b_axes))
    blocks.append((1, seq_axes))
    ql, kl, vl = (_Split.apply(t, mesh, blocks) for t in (q, k, v))
    if ug is not None and rg is not None:
        out = hybrid_sp_attention_local(ql, kl, vl, ug, rg, scale)
    elif rg is not None:
        out = ring_attention_local(ql, kl, vl, rg, scale)
    else:
        out = ulysses_attention_local(ql, kl, vl, ug, scale=scale)
    return _Gather.apply(out, mesh, blocks)
