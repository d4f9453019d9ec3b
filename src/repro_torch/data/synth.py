"""Deterministic synthetic data, the port of ``repro.data.synth``.

Every batch is a pure function of (seed, step), so a restart resumes the
stream with no data-state file.  ``graph_batch_from_csr`` draws from numpy's
generator from the same seed in the same order, so its arrays equal the JAX
package's.  ``lm_batch`` and ``recsys_batch`` use the JAX package's formulas
over draws from a ``torch.Generator`` seeded by (seed, step), on the CPU
whatever the device (so the card and the CPU get the same batch): JAX's
threefry bits cannot be reproduced, so their numbers differ from
``repro``'s (the tests give both packages JAX-made batches).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn.layers import GraphBatch


def lm_batch_specs(batch: int, seq: int) -> dict:
    """The global specs of ``lm_batch``'s batch (JAX's ``lm_batch_specs``)."""
    from repro_torch.configs.cell import TensorSpec

    return {"tokens": TensorSpec((batch, seq), torch.int32),
            "labels": TensorSpec((batch, seq), torch.int32)}


def recsys_batch_specs(batch: int, n_fields: int) -> dict:
    """The global specs of ``recsys_batch``'s batch (JAX's ``recsys_batch_specs``)."""
    from repro_torch.configs.cell import TensorSpec

    return {"ids": TensorSpec((batch, n_fields), torch.int32),
            "y": TensorSpec((batch,), torch.float32)}


def graph_batch_from_csr(g: CSRGraph, d_feat: int, seed: int = 0, n_classes: int = 8,
                         with_pos: bool = False, d_edge: int | None = None,
                         pad_edges_to: int | None = None, device="cuda") -> GraphBatch:
    """Wrap a host CSR graph as a padded GraphBatch on ``device``: normal node
    features, the edges then masked padding (ids 0), normal edge features,
    positions 3 x normal, labels in [0, n_classes)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = g.n
    src, dst = g.edges()
    m = src.shape[0]
    m_pad = pad_edges_to or m
    pad = m_pad - m
    if pad < 0:
        raise ValueError(f"{m} edges do not fit pad_edges_to = {m_pad}")

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    x = rng.standard_normal((n, d_feat)).astype(np.float32)
    edge_attr = rng.standard_normal((m_pad, d_edge)).astype(np.float32) if d_edge else None
    pos = 3.0 * rng.standard_normal((n, 3)).astype(np.float32) if with_pos else None
    y = rng.integers(0, n_classes, n).astype(np.int32)
    return GraphBatch(
        x=t(x),
        edge_src=t(np.concatenate([src, np.zeros(pad, np.int32)]).astype(np.int32)),
        edge_dst=t(np.concatenate([dst, np.zeros(pad, np.int32)]).astype(np.int32)),
        edge_mask=t(np.concatenate([np.ones(m, bool), np.zeros(pad, bool)])),
        node_mask=torch.ones(n, dtype=torch.bool, device=dev),
        edge_attr=None if edge_attr is None else t(edge_attr),
        pos=None if pos is None else t(pos),
        y=t(y),
    )


def _generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded by (seed, step), through numpy's SeedSequence."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def lm_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
             device="cuda") -> dict:
    """{tokens, labels}: int32[batch, seq], the labels next-token shifted.
    A Zipf-ish marginal (an exponential of uniforms) with short-range
    structure: three tokens in ten echo their predecessor plus 7."""
    dev = resolve_device(device)
    gen = _generator(seed, step)
    u = torch.rand((batch, seq + 1), generator=gen) * (1.0 - 1e-6) + 1e-6
    z = torch.floor(torch.exp(np.log(1.0 + vocab) * u) - 1.0).to(torch.int32)
    z = z.clamp(0, vocab - 1)
    echo = torch.roll(z, 1, dims=1) + 7
    mix = torch.rand(z.shape, generator=gen) < 0.3
    toks = torch.where(mix, echo.clamp(0, vocab - 1), z)
    return {"tokens": toks[:, :seq].contiguous().to(dev),
            "labels": toks[:, 1:].contiguous().to(dev)}


def recsys_batch(seed: int, step: int, batch: int, n_fields: int, vocab: int,
                 device="cuda") -> dict:
    """{ids int32[batch, n_fields], y float32[batch]}: uniform ids, clicks
    where a hash of the first two fields falls under 30 of 97 (a learnable
    signal)."""
    dev = resolve_device(device)
    ids = torch.randint(0, vocab, (batch, n_fields), generator=_generator(seed, step),
                        dtype=torch.int32)
    h = (ids[:, 0].long() * 2654435761 + ids[:, 1].long()) & 0xFFFFFFFF   # uint32 wrap
    return {"ids": ids.to(dev), "y": (h % 97 < 30).float().to(dev)}
