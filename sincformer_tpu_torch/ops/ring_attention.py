"""Ring attention: context-parallel attention over a mesh axis
(``sincformer_tpu/ops/ring_attention.py``).

Each rank holds a T/n block of frames of q, k and v. The K/V blocks travel
round the ring (``parallel.collectives.hop``: to the next rank, from the
previous), and every rank accumulates its queries' attention over each
visiting block with the online-softmax recurrence in float32, as the JAX
body does: a -1e30 start, n - 1 accumulate-and-hop steps, then the last
block with no hop, and ``acc / max(l, 1e-30)``. The block products are
``torch.matmul``, as JAX computes them with ``einsum`` outside any kernel.
The hop's backward sends the gradient back the way the block came (JAX's
autodiff of ``ppermute``), so every rank must run the backward together.

:func:`ring_attention_in_mesh` takes this rank's blocks (the shard_map
body's view: the model layer calls it through ``ops/attention.py``
``impl="ring"``); :func:`ring_attention` takes the whole sequence, as every
rank holds it, and returns this rank's block of the output.
"""

from __future__ import annotations

import torch

from sincformer_tpu_torch.parallel import collectives

_NEG = -1e30


def _ring_body(q, k, v, group, n_devices: int, scale: float):
    """q, k, v: (B, Tl, H, Dh) local blocks → (B, Tl, H, Dh)."""
    qh = q.transpose(1, 2).float()                       # (B, H, Tl, Dh)
    m = torch.full_like(qh[..., 0], _NEG)
    l = torch.zeros_like(qh[..., 0])
    acc = torch.zeros_like(qh)

    def accumulate(m, l, acc, kv):
        kh, vh = (t.transpose(1, 2).float() for t in kv.unbind(0))
        s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vh)
        return m_new, l, acc

    # K and V hop together: one exchange a step
    kv = torch.stack([k, v])
    for _ in range(n_devices - 1):
        m, l, acc = accumulate(m, l, acc, kv)
        kv = collectives.hop(kv, group)
    m, l, acc = accumulate(m, l, acc, kv)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def ring_attention_in_mesh(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh,
                           seq_axis: str = "data") -> torch.Tensor:
    """Attention of this rank's (B, Tl, H, Dh) query block over the key and
    value blocks of every rank of ``mesh[seq_axis]``, each rank holding
    the Tl frames of its place on the axis."""
    group = mesh.get_group(seq_axis)
    n = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    return _ring_body(q, k, v, group, n, scale)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, seq_axis: str = "data") -> torch.Tensor:
    """Context-parallel attention over ``mesh[seq_axis]``.

    Args:
        q, k, v: (B, T, H, Dh), the whole sequence, with T divisible by the
            axis size (raises otherwise, as JAX asserts).
        mesh: the DeviceMesh.
        seq_axis: the mesh axis that time is split over.

    Returns:
        This rank's (B, T/n, H, Dh) block of the attention output: the
        output stays split over time like the inputs.
    """
    n = mesh.size(mesh.mesh_dim_names.index(seq_axis))
    if q.shape[1] % n:
        raise ValueError(f"T={q.shape[1]} must divide the '{seq_axis}' "
                         f"axis size {n}")
    r, tl = mesh.get_local_rank(seq_axis), q.shape[1] // n
    block = lambda x: x[:, r * tl:(r + 1) * tl]  # noqa: E731
    return ring_attention_in_mesh(block(q), block(k), block(v), mesh,
                                  seq_axis)
