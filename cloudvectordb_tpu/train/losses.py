"""Contrastive losses for triplet-based encoder training (SURVEY.md §2.1).

Both keep the in-batch structure dense: the InfoNCE/MNRL similarity
matrix is one (B, B+B) matmul, no gather/scatter. Embeddings are assumed
L2-normalized when temperature scaling is used (the encoder default).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax


def triplet_margin_loss(anchor, positive, negative, margin: float = 0.5):
    """max(0, margin + d(a,p) - d(a,n)) with squared-L2 distances."""
    d_ap = jnp.sum((anchor - positive) ** 2, axis=-1)
    d_an = jnp.sum((anchor - negative) ** 2, axis=-1)
    return jnp.mean(jnp.maximum(0.0, margin + d_ap - d_an))


def infonce_loss(anchor, positive, negative=None, temperature: float = 0.05):
    """Multiple-negatives-ranking / InfoNCE over in-batch negatives.

    Row i's positive is positive[i]; all other positives (and the explicit
    negatives, if given) act as negatives. One matmul builds all logits.
    """
    cands = positive if negative is None else jnp.concatenate([positive, negative], 0)
    logits = (anchor @ cands.T) / temperature  # (B, B[+B])
    labels = jnp.arange(anchor.shape[0])
    loss = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    acc = jnp.mean(jnp.argmax(logits, axis=1) == labels)
    return jnp.mean(loss), acc


def uniformity_loss(x, t: float = 2.0):
    """Wang–Isola uniformity: log E[exp(−t·‖xi−xj‖²)] over in-batch pairs.

    Collapse diagnostic-turned-penalty: a collapsed batch (all embeddings
    equal) scores 0, a uniform-on-sphere batch ≈ −2t. Added with a small
    weight it keeps tiny from-scratch encoders from the degenerate optimum
    the pipeline's encode stage warns about (mean pairwise cosine ≈ 1).
    """
    # gram-matrix identity: ‖xi−xj‖² = ‖xi‖² + ‖xj‖² − 2·xi·xj — one
    # matmul and an O(B²) tensor instead of the O(B²·D) broadcast
    # difference (~200 MB + its cotangent at B=256, D=768)
    x2 = jnp.sum(x * x, axis=1)
    sq = jnp.maximum(x2[:, None] + x2[None, :] - 2.0 * x @ x.T, 0.0)
    b = x.shape[0]
    mask = ~jnp.eye(b, dtype=bool)
    return jax.scipy.special.logsumexp(
        jnp.where(mask, -t * sq, -jnp.inf)
    ) - jnp.log(b * (b - 1))


def loss_fn_for(name: str):
    if name == "infonce":
        return infonce_loss
    if name == "triplet":
        return triplet_margin_loss
    raise ValueError(f"unknown loss {name!r}")
