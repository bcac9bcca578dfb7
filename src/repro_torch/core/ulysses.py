"""DeepSpeed-Ulysses style all-to-all head-parallel attention, the baseline
of the paper's Table 1 (copy of ``repro.core.ulysses``).

The sequence-sharded q/k/v go through an all-to-all so that every rank
holds *all* tokens for a ``1/P`` slice of the heads; attention runs whole
on each rank (one flash call: kernel A forward, B1/B2 backward), then the
output goes through the inverse all-to-all back to sequence sharding.  On
the virtual ring the P ranks stay folded into the batch dimension, so that
one call is one launch over every rank's head slice.

The paper's Table-1 limitation is explicit here: the SP degree cannot
exceed the number of (KV) heads — :func:`ulysses_sp` raises for invalid
configurations and the registry marks the strategy ``head_divisible``, so
``"auto"`` passes it over there.

Communication per device: 4 all-to-alls moving ``S_loc*H*D*b`` each (q, k,
v in; out back) — constant in P.  The positions travel in an all-gather and
the lse (``return_lse``) in a fifth all-to-all; the cost model leaves both
out and the transports count them apart (``core.collectives``).
"""

from __future__ import annotations

from repro_torch.core.strategies import CommCost, register_strategy
from repro_torch.kernels.ops import flash_attention

__all__ = ["ulysses_sp", "ulysses_comm_cost"]


def ulysses_sp(q, k, v, q_pos, k_pos, *, ring, causal: bool = False,
               window: int | None = None, scale: float | None = None, impl: str = "auto",
               block_q: int = 512, block_k: int = 512, block_q_bwd: int | None = None,
               block_k_bwd: int | None = None, overlap: bool = True,
               return_lse: bool = False):
    """Ulysses on the local shards over the transport ``ring`` (``overlap``
    is taken for the uniform signature: there is no step loop to
    pipeline)."""
    P = ring.size
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq % P or Hkv % P:
        raise ValueError(
            f"Ulysses needs head counts divisible by the SP degree: "
            f"Hq={Hq}, Hkv={Hkv}, P={P} (the paper's Table-1 limitation)"
        )

    def seq_to_head(x):
        # (B, S_loc, H, D) -> (B, S_loc * P, H / P, D)
        return ring.all_to_all(x, 2, 1)

    def head_to_seq(x):
        return ring.all_to_all(x, 1, 2)

    qh, kh, vh = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    # positions of the gathered sequence: every rank's local positions in
    # rank order along the sequence (the all-to-all's order)
    qp_all = ring.all_gather(q_pos, 1)
    kp_all = ring.all_gather(k_pos, 1)
    out, lse = flash_attention(
        qh, kh, vh, q_pos=qp_all, k_pos=kp_all, causal=causal, window=window, scale=scale,
        impl=impl, block_q=block_q, block_k=block_k, block_q_bwd=block_q_bwd,
        block_k_bwd=block_k_bwd,
    )
    out = head_to_seq(out)
    if not return_lse:
        return out
    # lse: (B, S, Hq/P) head-sharded -> back to sequence-sharded (B, S_loc, Hq)
    lse = ring.all_to_all(lse[..., None], 1, 2, lse=True)[..., 0]
    return out, lse


def ulysses_comm_cost(B, S, Hq, Hkv, D, P, *, bytes_per_elem=2, bidir_links=True, S_kv=None,
                      **_):
    """Four all-to-alls (q, k, v in; out back), volume constant in P.

    q and out move ``S`` rows of ``Hq`` heads; k and v move ``S_kv`` rows of
    ``Hkv`` heads (equal to the self-attention closed form when S_kv == S).
    """
    Sq_loc = S // P
    Skv_loc = (S_kv or S) // P
    a2a = 2 * B * (Sq_loc * Hq + Skv_loc * Hkv) * D * bytes_per_elem
    return CommCost(a2a / 2, a2a / 2)


register_strategy(
    "ulysses",
    ulysses_sp,
    comm_cost=ulysses_comm_cost,
    head_divisible=True,  # the paper's Table-1 limitation: SP degree <= heads
    pipelines=False,  # blocking all-to-alls gate the local flash both ways
    description="DeepSpeed-Ulysses all-to-all head parallelism",
)
