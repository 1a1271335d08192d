"""Ring attention — context parallelism for long sequences, the port of
``paddle_tpu/parallel/ring_attention.py``.

The sequence is split over the ``cp`` ranks of a process group: each rank
keeps its chunk of Q and passes its K/V chunk around the ring, combining
the partial attentions in a float32 online softmax, as flash attention
combines K/V tiles inside one card. JAX runs the ring as a ``lax.scan``
over ``ppermute`` and differentiates it by transposition; the port runs
it as point-to-point exchanges (``batch_isend_irecv``) inside a
``torch.autograd.Function`` whose backward is the reverse ring: K/V
travel the other way with their dK/dV accumulators, which arrive home
with the rank's own chunk. JAX computes it with einsums and no Pallas
kernel; so does the port, with plain torch ops.

Over gloo, CUDA tensors are staged through host memory around each
exchange (as ``mesh.AxisGroup`` stages its collectives).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

from . import mesh as mesh_mod

__all__ = ["ring_attention"]

_MASK = -1e30


class _Ring:
    """This rank's place on the ring: size, index, the global ranks of its
    neighbours, the process group and whether exchanges are staged."""

    def __init__(self, group):
        if isinstance(group, mesh_mod.AxisGroup):
            self.size, self.index = group.size, group.index
            ranks, self.pg, self.stage = group.ranks, group.group, group.stage
        else:
            self.pg = group
            self.size = dist.get_world_size(group)
            self.index = dist.get_rank(group)
            ranks = [i if group is None else dist.get_global_rank(group, i)
                     for i in range(self.size)]
            self.stage = dist.get_backend(group) == "gloo"
        self.next = ranks[(self.index + 1) % self.size]
        self.prev = ranks[(self.index - 1) % self.size]

    def rotate(self, tensors: List[torch.Tensor], forward: bool
               ) -> List[torch.Tensor]:
        """Send each tensor one step along the ring (to the next rank when
        ``forward``, else to the previous) and return the ones that arrive
        from the other side."""
        dst, src = (self.next, self.prev) if forward else (self.prev,
                                                           self.next)
        dev = tensors[0].device
        stage = self.stage and dev.type == "cuda"
        outs, ops = [], []
        for i, t in enumerate(tensors):
            buf = (t.cpu() if stage else t).contiguous()
            out = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.isend, buf, dst, self.pg, tag=i))
            ops.append(dist.P2POp(dist.irecv, out, src, self.pg, tag=i))
            outs.append(out)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [o.to(dev) for o in outs] if stage else outs


def _scores(q32, kc, scale, causal, src, my):
    """[b, nh, tq, tk] float32 scores of this rank's queries against chunk
    ``src``, with the chunk-level causal mask: chunks after ``my`` fully
    masked, ``src == my`` lower-triangular."""
    s = torch.einsum("bqhd,bkhd->bhqk", q32, kc.float()) * scale
    if causal:
        if src > my:
            s = torch.full_like(s, _MASK)
        elif src == my:
            tl = s.shape[-1]
            keep = torch.ones(tl, tl, dtype=torch.bool,
                              device=s.device).tril()
            s = torch.where(keep, s, torch.full_like(s, _MASK))
    return s


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        cp, my = ring.size, ring.index
        q32 = q.float()
        b, tl, nh, hd = q.shape
        m = torch.full((b, nh, tl), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, nh, tl, hd), dtype=torch.float32,
                          device=q.device)
        kc, vc = k, v
        # cp - 1 rotate-and-accumulate steps, then the last chunk consumed
        # without a final exchange
        for i in range(cp):
            if i:
                kc, vc = ring.rotate([kc, vc], forward=True)
            s = _scores(q32, kc, scale, causal, (my - i) % cp, my)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vc.float())
            m = m_new
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out = acc / l[..., None]
        # kc, vc now hold chunk my + 1: the reverse ring starts there
        ctx.save_for_backward(q, kc, vc, out, m + torch.log(l))
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, kc, vc, out, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        cp, my = ring.size, ring.index
        q32 = q.float()
        do = dout.float().transpose(1, 2)               # [b, nh, tl, hd]
        di = (do * out).sum(-1)                         # [b, nh, tl]
        dq = torch.zeros_like(out)
        dk = torch.zeros(kc.shape, dtype=torch.float32, device=kc.device)
        dv = torch.zeros_like(dk)
        # step i of the forward in reverse: chunk (my - i) comes from the
        # next rank with the dK/dV its earlier holders accumulated, and
        # leaves for the previous one; at i = 0 it is this rank's own
        for i in range(cp - 1, -1, -1):
            if i < cp - 1:
                kc, vc, dk, dv = ring.rotate([kc, vc, dk, dv], forward=False)
            s = _scores(q32, kc, scale, causal, (my - i) % cp, my)
            p = torch.exp(s - lse[..., None])
            dv = dv + torch.einsum("bhqk,bhqd->bkhd", p, do)
            dp = torch.einsum("bhqd,bkhd->bhqk", do, vc.float())
            ds = p * (dp - di[..., None]) * scale
            dq = dq + torch.einsum("bhqk,bkhd->bhqd", ds, kc.float())
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q32)
        return (dq.transpose(1, 2).to(q.dtype), dk.to(kc.dtype),
                dv.to(vc.dtype), None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group=None, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise ring attention over the ranks of ``group`` (a line of the
    port's mesh, ``mesh.group("cp")``, a ``torch.distributed`` group, or
    None for the world). q, k, v are this rank's chunks [B, T/cp, nh, hd]
    of a sequence split in rank order (rank i holds rows [i·Tl, (i+1)·Tl));
    returns its chunk of the output in q's dtype. Differentiable: the
    backward runs the reverse ring (every rank must call it)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, _Ring(group), bool(causal),
                                float(sm_scale))
