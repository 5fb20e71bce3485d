"""Ring-permuted global InfoNCE and sigmoid loss over point-to-point sends.

Port of ``clipa_tpu/ops/ring_infonce.py``. In place of all-gathering the
(B, C) text embeddings before one (B, B) logit product, each process keeps
its own (b, C) rows and the text shard travels the ring ``j -> j + 1``
(``torch.distributed.batch_isend_irecv``): at hop k process r holds the
text shard of process r - k, so no process holds more than one (b, b)
logit block.

  * :func:`ring_contrastive_loss`, the bidirectional InfoNCE: the img->txt
    log-sum-exp of a row is local; the txt->img log-sum-exp of a text shard
    accumulates in a packet that travels WITH the shard and is home after n
    hops. ``ncorrect`` is ``pos >= img_max`` (the JAX ring's, which is not
    the softmax loss's argmax).
  * :func:`ring_sigmoid_contrastive_loss`, SigLIP's pod algorithm: each hop
    folds one block of independent binary terms into this process's rows;
    positives appear only at hop 0, on the diagonal of the home block.

Each returns this process's share of the global loss: with `reduction`, the
mean over its rows, so the global loss (the JAX ring's ``pmean``) is the
mean over processes, and the gradients each process's backward returns for
its own rows (and its partial sums for ``t`` and ``bias``) are those of
the sum of the processes' losses: the training step averages them over the
world. Memory: the ring's :class:`torch.autograd.Function` keeps only its
inputs and the (b,) log-sum-exps; its backward recomputes each (b, b) block
(as ``jax.checkpoint`` on the JAX scan body) and sends the gradient of each
rotated text shard back around the ring with the shard, so live memory per
process stays O(b * (C + b)). With one process (or no process group) the
ring is one hop with no sends.

The logit products are fp32 with TF32 off (the JAX ring asks for
``Precision.HIGHEST``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from clipa_tpu_torch.losses import full_fp32_matmul
from clipa_tpu_torch.parallel import collectives

# the `group` of a batch that is this process's alone: one hop, no sends,
# whatever process group exists
ALONE = "alone"


def _ring(group) -> tuple[int, int, int]:
    """(size, next process, previous process) of the ring over `group`
    (global ranks); (1, 0, 0) without a process group or for ``ALONE``."""
    if group is ALONE or not (dist.is_available() and dist.is_initialized()):
        return 1, 0, 0
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    peer = ((lambda i: i) if group is None
            else (lambda i: dist.get_global_rank(group, i)))
    return n, peer((r + 1) % n), peer((r - 1) % n)


def _shift(tensors: list, ring: tuple, group) -> list:
    """Sends `tensors` ((b, k) each) to the next process and receives the
    previous process's, packed into one message."""
    collectives.calls["ring_shift"] += 1
    _, nxt, prev = ring
    widths = [x.shape[1] for x in tensors]
    packed = torch.cat(tensors, dim=1).contiguous()
    got = torch.empty_like(packed)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, packed, nxt, group),
        dist.P2POp(dist.irecv, got, prev, group)])
    for req in reqs:
        req.wait()
    return list(torch.split(got, widths, dim=1))


class _RingSoftmax(torch.autograd.Function):
    """``apply(zimg, ztxt, t, group) -> (img_lse, txt_lse, img_max)``: the
    row log-sum-exps of this process's image rows against every text row,
    the column log-sum-exps of its text rows against every image row, and
    the image rows' largest logit (not differentiable)."""

    @staticmethod
    def forward(ctx, zimg, ztxt, t, group):
        ring = _ring(group)
        b = zimg.shape[0]
        neg_inf = torch.full((b,), float("-inf"), device=zimg.device)
        img_lse, img_max = neg_inf, neg_inf
        cur, cur_lse = ztxt, neg_inf
        with full_fp32_matmul():
            for _ in range(ring[0]):
                block = (zimg @ cur.T) * t
                img_lse = torch.logaddexp(img_lse,
                                          torch.logsumexp(block, dim=1))
                img_max = torch.maximum(img_max, block.amax(dim=1))
                cur_lse = torch.logaddexp(cur_lse,
                                          torch.logsumexp(block, dim=0))
                if ring[0] > 1:   # the shard and its packet travel together
                    cur, cur_lse = _shift([cur, cur_lse[:, None]], ring,
                                          group)
                    cur_lse = cur_lse[:, 0]
        ctx.save_for_backward(zimg, ztxt, t, img_lse, cur_lse)
        ctx.group = group
        ctx.mark_non_differentiable(img_max)
        return img_lse, cur_lse, img_max

    @staticmethod
    def backward(ctx, g_img, g_txt, _):
        zimg, ztxt, t, img_lse, txt_lse = ctx.saved_tensors
        ring = _ring(ctx.group)
        g_img = torch.zeros_like(img_lse) if g_img is None else g_img
        g_txt = torch.zeros_like(txt_lse) if g_txt is None else g_txt
        d_img = torch.zeros_like(zimg)
        d_t = torch.zeros((), device=zimg.device)
        cur, cur_lse, cur_g = ztxt, txt_lse, g_txt
        cur_d = torch.zeros_like(ztxt)
        with full_fp32_matmul():
            for _ in range(ring[0]):
                raw = zimg @ cur.T
                block = raw * t
                w = (g_img[:, None] * torch.exp(block - img_lse[:, None])
                     + cur_g[None, :] * torch.exp(block - cur_lse[None, :]))
                d_img = d_img + (w @ cur) * t
                cur_d = cur_d + (w.T @ zimg) * t
                d_t = d_t + (w * raw).sum()
                if ring[0] > 1:   # the shard's gradient travels with it
                    cur, cur_lse, cur_g, cur_d = _shift(
                        [cur, cur_lse[:, None], cur_g[:, None], cur_d], ring,
                        ctx.group)
                    cur_lse, cur_g = cur_lse[:, 0], cur_g[:, 0]
        return d_img, cur_d, d_t.reshape(t.shape), None


def ring_contrastive_loss(zimg: torch.Tensor, ztxt: torch.Tensor,
                          t: torch.Tensor, group=None,
                          reduction: bool = True):
    """The bidirectional InfoNCE of the whole batch, on the ring.

    Args:
      zimg, ztxt: this process's (b, C) L2-normalized rows of the global
        batch (the batch rule of ``parallel/mesh.py``).
      t: the exp'd temperature, scalar or (1,), the same on every process.
      group: the process group of the ring (default: the whole group;
        ``ALONE``: this process's batch is the whole batch).

    Returns:
      (loss, {"ncorrect": ...}): this process's rows' mean with
      `reduction` (module docstring), else per row.
    """
    zimg, ztxt = zimg.float(), ztxt.float()
    t = t.float()
    pos = (zimg * ztxt).sum(dim=-1) * t.reshape(())
    img_lse, txt_lse, img_max = _RingSoftmax.apply(zimg, ztxt,
                                                   t.reshape(()), group)
    loss = 0.5 * ((img_lse - pos) + (txt_lse - pos))
    ncorrect = (pos >= img_max).float()
    if reduction:
        return loss.mean(), {"ncorrect": ncorrect.mean()}
    return loss, {"ncorrect": ncorrect}


class _RingSigmoid(torch.autograd.Function):
    """``apply(zimg, ztxt, t, bias, group) -> (b,)``: each image row's sum of
    ``softplus(-sign * (t * zimg . ztxt + bias))`` over every text row."""

    @staticmethod
    def forward(ctx, zimg, ztxt, t, bias, group):
        ring = _ring(group)
        b = zimg.shape[0]
        eye = torch.eye(b, device=zimg.device)
        acc = torch.zeros(b, device=zimg.device)
        cur = ztxt
        with full_fp32_matmul():
            for hop in range(ring[0]):
                block = (zimg @ cur.T) * t + bias
                signs = 2.0 * eye * (hop == 0) - 1.0
                acc = acc + torch.nn.functional.softplus(
                    -signs * block).sum(dim=1)
                if ring[0] > 1:
                    (cur,) = _shift([cur], ring, group)
        ctx.save_for_backward(zimg, ztxt, t, bias)
        ctx.group = group
        return acc

    @staticmethod
    def backward(ctx, g):
        zimg, ztxt, t, bias = ctx.saved_tensors
        ring = _ring(ctx.group)
        eye = torch.eye(zimg.shape[0], device=zimg.device)
        d_img = torch.zeros_like(zimg)
        d_t = torch.zeros((), device=zimg.device)
        d_bias = torch.zeros((), device=zimg.device)
        cur, cur_d = ztxt, torch.zeros_like(ztxt)
        with full_fp32_matmul():
            for hop in range(ring[0]):
                raw = zimg @ cur.T
                signs = 2.0 * eye * (hop == 0) - 1.0
                z = -signs * (raw * t + bias)
                w = g[:, None] * (-signs) * torch.sigmoid(z)
                d_img = d_img + (w @ cur) * t
                cur_d = cur_d + (w.T @ zimg) * t
                d_t = d_t + (w * raw).sum()
                d_bias = d_bias + w.sum()
                if ring[0] > 1:
                    cur, cur_d = _shift([cur, cur_d], ring, ctx.group)
        return (d_img, cur_d, d_t.reshape(t.shape),
                d_bias.reshape(bias.shape), None)


def ring_sigmoid_contrastive_loss(zimg: torch.Tensor, ztxt: torch.Tensor,
                                  t: torch.Tensor, bias=0.0, group=None,
                                  reduction: bool = True):
    """SigLIP's pairwise sigmoid loss of the whole batch, on the ring:
    ``losses.sigmoid_contrastive_loss`` of the gathered batch, this
    process's rows. Args as :func:`ring_contrastive_loss`, plus `bias`, the
    learned logit bias (a tensor or a number). Returns (this process's
    rows' mean, or its per-row sums without `reduction`, {})."""
    zimg, ztxt = zimg.float(), ztxt.float()
    if not torch.is_tensor(bias):
        bias = torch.tensor(float(bias), device=zimg.device)
    acc = _RingSigmoid.apply(zimg, ztxt, t.float().reshape(()),
                             bias.float().reshape(()), group)
    return (acc.mean() if reduction else acc), {}
