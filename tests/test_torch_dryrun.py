"""The dry run (``repro_torch.launch.dryrun``, ``launch.step_analysis``)
against the JAX package's dry run and against itself on real tensors.

1. ``params_total`` and ``params_active`` of every ``ASSIGNED`` arch at
   full size equal the JAX counts over ``jax.eval_shape(bundle.init)`` (the
   reference's ``_param_counts``, copied here: importing
   ``repro.launch.dryrun`` would set ``XLA_FLAGS`` to 512 host devices for
   the whole worker).
2. Rank 0's parameter and AdamW-moment bytes on (16, 16) and (2, 16, 16)
   in train storage, and its blocks' elements in serve storage, equal the
   JAX specs' shard sizes on an ``AbstractMesh``.
3. The ``plan`` record (strategy, inner, predicted link bytes, adaptive
   prefill picks, the two-pod topology decision) equals the JAX
   ``ParallelContext``'s for a train, a prefill and a decode cell.
4. The tracker's peak on fake tensors equals its peak on real CPU tensors
   (``impl="torch"``) for a 2-layer narrow model's train and decode steps.
5. Each kernel wrapper's shape path gives the kernel's outputs (and a decode
   call's partials by the split rule at 132 SMs) and counts no launch.
6. The mini direction accounting (``repro.testing.dryrun_check``'s) and 7.
   ``run_cell("qwen3-1.7b", "train_4k")`` at full size over a fake group of
   256 ranks run in a process of their own (``tests/_dryrun_worker.py``;
   ``init_process_group`` holds one group a process).

Every comparison is exact, but for the layout's closed form of the pairs
(its means, summed over a pass, to a relative 1e-12).
"""

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.configs import ASSIGNED as JASSIGNED
from repro.core.api import ParallelContext as JPctx
from repro.launch import mesh as jmesh
from repro.models import SHAPES as JSHAPES
from repro.models import build_model as jbuild
from repro.sharding import rules as jrules
from repro_torch.configs import ARCHS, ASSIGNED
from repro_torch.core.api import ParallelContext
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_pctx
from repro_torch.launch.step_analysis import StepAnalysis
from repro_torch.models.config import SHAPES
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import adamw_init, tree_map
from repro_torch.sharding import layout_for, state_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
_EXPERT_KEYS = ("wg", "wu", "wd")


def _jax_param_counts(param_specs, cfg):
    """``repro.launch.dryrun._param_counts``, copied."""
    total = 0
    expert = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(param_specs)[0]:
        n = math.prod(leaf.shape)
        total += n
        keys = [getattr(k, "key", None) for k in path]
        if keys and keys[-1] in _EXPERT_KEYS:
            expert += n
    active = total
    if cfg.n_experts:
        active = total - expert + expert * cfg.n_experts_per_token / cfg.n_experts
    return total, active


def _jax_shapes(cfg):
    jb = jbuild(cfg, JPctx(mesh=None, impl="xla"))
    return jax.eval_shape(jb.init, jax.random.PRNGKey(0))


def test_assigned_matches_jax():
    assert ASSIGNED == JASSIGNED and "llama2-7b" not in ASSIGNED


@pytest.mark.parametrize("arch", JASSIGNED)
def test_param_counts_match_jax(arch):
    jtotal, jactive = _jax_param_counts(_jax_shapes(JARCHS[arch]), JARCHS[arch])
    total, active = dryrun.param_counts(dryrun.meta_params(ARCHS[arch], training=True),
                                        ARCHS[arch])
    assert (total, active) == (jtotal, jactive)


def _jax_shard_elems(shapes, jm, mode):
    """Rank 0's elements of every leaf by the JAX rules (a stacked leaf's
    rule is its spec with the leading ``None``)."""
    out = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        spec = tuple(jrules.param_pspec(path, leaf.shape, jm, mode))
        n = 1
        for dim, e in zip(leaf.shape, spec + (None,) * (len(leaf.shape) - len(spec))):
            axes = e if isinstance(e, tuple) else (() if e is None else (e,))
            n *= dim // math.prod(jm.shape[a] for a in axes)
        out += n * leaf.dtype.itemsize
    return out


def _as(tree, dtype):
    return tree_map(lambda x: torch.empty(x.shape, dtype=dtype, device="meta"), tree)


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh_id", sorted(MESHES))
@pytest.mark.parametrize("arch", JASSIGNED)
def test_rank0_state_bytes_match_jax(arch, mesh_id, mode):
    """Train: the float32 parameters' bytes and both float32 AdamW moments'.
    Serve: the elements of every block (a one-byte float stands for each),
    since the JAX init keeps the layer matrices in float32 under
    ``param_dtype="bfloat16"`` where the port's serving layout holds
    bfloat16; the bytes the dry run records are the port's."""
    names, sizes = MESHES[mesh_id]
    jm, tm = AbstractMesh(sizes, names), Mesh(names, sizes)
    over = {} if mode == "train" else {"param_dtype": "bfloat16"}
    jshapes = _jax_shapes(JARCHS[arch].with_(**over))
    meta = dryrun.meta_params(ARCHS[arch].with_(**over), training=mode == "train")
    if mode == "train":
        assert state_bytes(layout_for(meta, tm, rank=0)) == _jax_shard_elems(jshapes, jm, mode)
        f32 = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, np.float32), jshapes)
        moments = _as(meta, torch.float32)
        got = state_bytes(layout_for({"m": moments, "v": moments}, tm, rank=0))
        assert got == 2 * _jax_shard_elems(f32, jm, mode)
    else:
        one = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, np.int8), jshapes)
        got = state_bytes(layout_for(_as(meta, torch.float8_e4m3fn), tm, rank=0, mode=mode))
        assert got == _jax_shard_elems(one, jm, mode)


def _jax_plan_info(cfg, shape, jp, kind):
    """The reference's ``plan`` record (``repro/launch/dryrun.py:214-315``)
    less its modeled times, which take the TPU's constants."""
    import jax.numpy as jnp

    from repro.core.api import AttnShapes

    shapes = AttnShapes(B=shape.global_batch, Sq=shape.seq_len, Hq=cfg.n_heads,
                        Hkv=cfg.n_kv_heads, D=cfg.head_dim,
                        dtype_bytes=jnp.dtype(cfg.dtype).itemsize)
    if kind != "decode":
        plan = jp.plan(shapes, causal=cfg.causal, window=cfg.window)
        info = {"strategy": plan.strategy, "inner": plan.inner,
                "predicted_link_bytes_fwd": plan.cost.fwd_bytes,
                "predicted_link_bytes_bwd": plan.cost.bwd_bytes}
        if kind == "prefill":
            info["adaptive_prefill"] = {f"hit_rate_{r}": jp.choose_prefill_strategy(
                shapes, prefix_hit_rate=r) for r in (0.0, 0.5, 0.95)}
        if len(jp.sp_axes) == 2 and jp.mesh.shape[jp.sp_axes[0]] == 2:
            from repro.core.topology import two_pods

            info["topology"] = jp.plan(shapes, causal=cfg.causal, window=cfg.window,
                                       topology=two_pods(jp.sp_degree // 2)).topology_decision
        return info
    plan = jp.plan_decode(window=cfg.window, shapes=AttnShapes(
        B=shape.global_batch, Sq=1, Hq=cfg.n_heads, Hkv=cfg.n_kv_heads, D=cfg.head_dim,
        Sk=shape.seq_len, dtype_bytes=jnp.dtype(cfg.dtype).itemsize))
    return {"strategy": plan.strategy, "inner": plan.inner,
            "predicted_link_bytes_fwd": plan.cost.fwd_bytes,
            "predicted_link_bytes_bwd": plan.cost.bwd_bytes, "kernel": plan.kernel}


def _jsonable(x):
    return json.loads(json.dumps(x, default=str))


@pytest.mark.parametrize("arch,shape_name,mesh_id", [
    ("qwen3-1.7b", "train_4k", "16x16"),
    ("qwen3-moe-30b-a3b", "prefill_32k", "2x16x16"),
    ("granite-3-8b", "decode_32k", "16x16"),
])
def test_plan_matches_jax(arch, shape_name, mesh_id):
    names, sizes = MESHES[mesh_id]
    jm, tm = AbstractMesh(sizes, names), Mesh(names, sizes)
    shape = SHAPES[shape_name]
    cfg = ARCHS[arch]
    if shape.kind != "train":
        cfg = cfg.with_(param_dtype="bfloat16", remat="none")
    jp = jmesh.make_pctx(jm, layout=cfg.layout, global_batch=shape.global_batch)
    want = _jax_plan_info(JARCHS[arch], JSHAPES[shape_name], jp, shape.kind)
    pctx = make_pctx(tm, layout=cfg.layout, global_batch=shape.global_batch, device="cpu")
    got = dryrun._plan_info(cfg, shape, pctx, shape.kind, tm)
    got = {k: v for k, v in got.items() if k in want}
    assert _jsonable(got) == _jsonable(want)
    if shape.kind == "prefill":
        assert set(want) >= {"adaptive_prefill", "topology"}


NARROW = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_head=32, d_ff=256,
              vocab_size=97, logits_chunk=64, dtype="float32")


def _peak(kind, fake: bool) -> int:
    """The tracker's high-water of one step of a 2-layer narrow qwen3-1.7b
    on the CPU's plain path, on real tensors or on fake ones of the same
    shapes (the positions' shadows from the real batch and state)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.train_step import make_train_step

    cfg = ARCHS["qwen3-1.7b"].reduced(**NARROW)
    if kind == "decode":
        cfg = cfg.with_(remat="none")
    bundle = build_model(cfg, ParallelContext(device="cpu", impl="torch"))
    B, S = 2, 64
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, 97, (B, S), generator=gen, dtype=torch.int32),
             "labels": torch.randint(0, 97, (B, S), generator=gen, dtype=torch.int32),
             "positions": torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()}
    state = bundle.init_serve_state(B, S, "cpu")
    analysis = StepAnalysis()

    def run(params, batch, state):
        if kind == "train":
            opt = adamw_init(params)
            analysis.track(params, "params")
            analysis.track(opt, "opt")
            analysis.track(batch, "batch")
            with analysis:
                make_train_step(bundle)(params, opt, batch)
        else:
            tok = batch["tokens"][:, 0].contiguous()
            analysis.track(params, "params")
            analysis.track(state, "state")
            analysis.track(tok, "batch")
            with analysis:
                bundle.decode_step(params, tok, state)

    if not fake:
        run(bundle.init(0, training=kind == "train"), batch, state)
        return analysis.peak
    seeds = {"positions": batch["positions"], "pos": state["pos"], "len": state["len"]}
    with FakeTensorMode():
        params = dryrun._empty_like_tree(dryrun.meta_params(cfg, training=kind == "train"),
                                         "cpu")
        fb = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in batch.items()}
        fs = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in state.items()}
        for k, t in (("positions", fb["positions"]), ("pos", fs["pos"]), ("len", fs["len"])):
            analysis.shadow(t, seeds[k])
        run(params, fb, fs)
    return analysis.peak


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_tracker_peak_fake_equals_real(kind):
    real, fake = _peak(kind, False), _peak(kind, True)
    assert real > 0 and fake == real


@pytest.mark.parametrize("layout", ["contig", "zigzag"])
@pytest.mark.parametrize("strategy", ["ring", "tokenring", "both"])
def test_layout_pairs_of_a_pass_sum_to_the_pairs(strategy, layout):
    """A pass on rank 0 of 4 whose far side's positions arrive over a link
    (no shadow): Ring's calls take rank 0's queries against each other
    rank's keys, TokenRing's each other rank's query halves against rank
    0's keys, and "both" each other rank's query halves against a third
    rank's keys (the pod ring's hop of the hybrid), both sides arrived.
    The layout's closed form sums to the pairs the kernels compute on the
    real positions (to the rounding of its means), resolves every call
    and, under zigzag, counts each call's half."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.data.synthetic import apply_layout
    from repro_torch.kernels.flash_attention import tile_skip_grid
    from repro_torch.launch.step_analysis import ATTENTION_COEF, computed_pairs

    P, S, B, H, D, tiles = 4, 512, 2, 2, 32, (64, 64)
    z = np.zeros((1, S), np.int32)
    blocks = torch.from_numpy(apply_layout(z, z, S, P, layout)[2][0]).reshape(P, -1)
    own = blocks[0].expand(B, S // P)
    halves = [(r, h.expand(B, S // (2 * P))) for r in range(1, P)
              for h in blocks[r].reshape(2, -1)]
    whole = [(r, blocks[r].expand(B, S // P)) for r in range(1, P)]
    calls = {"ring": [((0, own), k) for k in whole],
             "tokenring": [(q, (0, own)) for q in halves],
             "both": [(q, k) for q in halves for k in whole if q[0] != k[0]]}[strategy]
    want = sum(computed_pairs(q, k, *tiles, causal=True, window=None, skip_grid=tile_skip_grid)
               for (_, q), (_, k) in calls)
    analysis = StepAnalysis(seq_blocks=blocks)
    with FakeTensorMode():
        fake_own = torch.empty(B, S // P, dtype=torch.int32)
        analysis.shadow(fake_own, own)
        for (rq, q), (rk, k) in calls:  # only rank 0's side has a shadow
            qp, kp = (fake_own if r == 0 else torch.empty(p.shape, dtype=torch.int32)
                      for r, p in ((rq, q), (rk, k)))
            analysis.attention_call("flash_attention_fwd", q=torch.empty(B, qp.shape[1], H, D),
                                    Sk=kp.shape[1], q_pos=qp, k_pos=kp, causal=True,
                                    window=None, tiles=tiles, nbytes=0)
    st = analysis.stats
    assert st.attention_calls_unresolved == 0
    assert st.attention_flops == pytest.approx(ATTENTION_COEF["flash_attention_fwd"] * D * H
                                               * want, rel=1e-12)
    if layout == "zigzag":  # two ranks' blocks: half their pairs, call by call
        assert st.attention_flops == st.attention_flops_full / 2


class _Allocs(torch.utils._python_dispatch.TorchDispatchMode):
    """The shapes and dtypes of every tensor a call allocates."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket in (torch.ops.aten.empty, torch.ops.aten.zeros,
                                    torch.ops.aten.empty_like):
            self.made.append((tuple(out.shape), out.dtype))
        return out


def _launches():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    return (fa.flash_attention_fwd_cuda.launches, fa.flash_attention_bwd_dq_cuda.launches,
            fa.flash_attention_bwd_dkv_cuda.launches, pa.paged_decode_fwd_cuda.launches)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernel_shape_path(dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    before = _launches()
    calls = []
    fa.FAKE_CALL_OBSERVERS.append(lambda kernel, **kw: calls.append(kernel))
    try:
        with FakeTensorMode():
            i32 = torch.int32
            B, S, Hq, Hkv, D = 2, 256, 8, 2, 64
            q = torch.empty(B, S, Hq, D, dtype=dtype)
            k, v = (torch.empty(B, S, Hkv, D, dtype=dtype) for _ in range(2))
            qp = kp = torch.empty(B, S, dtype=i32)
            out, lse = fa.flash_attention_fwd_cuda(q, k, v, qp, kp, causal=True, window=None,
                                                   scale=0.125)
            assert (out.shape, out.dtype) == (q.shape, dtype)
            assert (lse.shape, lse.dtype) == ((B, S, Hq), torch.float32)
            stats = [torch.empty(B, S, Hq) for _ in range(3)]
            dq = fa.flash_attention_bwd_dq_cuda(q, k, v, qp, kp, q, *stats, causal=True,
                                                window=None, scale=0.125)
            dk, dv = fa.flash_attention_bwd_dkv_cuda(q, k, v, qp, kp, q, *stats, causal=True,
                                                     window=None, scale=0.125)
            assert (dq.shape, dq.dtype) == (q.shape, torch.float32)
            assert (dk.shape, dv.shape, dk.dtype) == (k.shape, k.shape, torch.float32)
            # a decode call: the partials of the split rule at 132 SMs
            Bd, Sk, Hq, Hkv, D = 8, 4096, 16, 8, 128
            q1 = torch.empty(Bd, 1, Hq, D, dtype=dtype)
            kd = torch.empty(Bd, Sk, Hkv, D, dtype=dtype)
            qp1, kpd = torch.empty(Bd, 1, dtype=i32), torch.empty(Bd, Sk, dtype=i32)
            with _Allocs() as allocs:
                out, lse = fa.flash_attention_fwd_cuda(q1, kd, kd, qp1, kpd, causal=True,
                                                       window=None, scale=0.125)
            units = fa.decode_units(Bd, Hq, Hkv, 1)
            _, splits = fa.decode_split_rule(Sk, units, fa.DRYRUN_SM_COUNT)
            assert splits > 1
            assert allocs.made == [((Bd, 1, Hq, D), dtype), ((Bd, 1, Hq), torch.float32),
                                   ((units,), i32), ((splits, Bd * Hq, D), torch.float32),
                                   ((splits, Bd * Hq), torch.float32)]
            # kernel C on a page pool
            n_pages, ps, W = 64, 16, 32
            pool = torch.empty(n_pages, ps, Hkv, D, dtype=dtype)
            pos_pool, table = torch.empty(n_pages, ps, dtype=i32), torch.empty(Bd, W, dtype=i32)
            with _Allocs() as allocs:
                out, lse = pa.paged_decode_fwd_cuda(q1, pool, pool, pos_pool, table, qp1,
                                                    window=None, scale=0.125)
            assert (out.shape, lse.shape) == (q1.shape, (Bd, 1, Hq))
            _, splits = fa.decode_split_rule(W * ps, units, fa.DRYRUN_SM_COUNT)
            want = [((Bd, 1, Hq, D), dtype), ((Bd, 1, Hq), torch.float32)]
            if splits > 1:
                want += [((units,), i32), ((splits, Bd * Hq, D), torch.float32),
                         ((splits, Bd * Hq), torch.float32)]
            assert allocs.made == want
    finally:
        fa.FAKE_CALL_OBSERVERS.pop()
    assert _launches() == before
    assert calls == ["flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                     "flash_attention_fwd", "paged_decode_fwd"]


@pytest.mark.parametrize("lo,hi", [(0, 8), (8, 24), (16, 40), (24, 40)])
def test_embed_rows_is_the_embedding_sliced(lo, hi):
    """A VLM rank's shard of its sequence (``_embed_rows``, the process
    group's path) equals rows ``[lo, hi)`` of the whole sequence's
    embedding, across the image's end (16 slots) and inside either part."""
    from repro_torch.models import transformer as T

    cfg = ARCHS["pixtral-12b"].reduced()
    params = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    B, n_img, S_text = 2, cfg.frontend_tokens, 24
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, S_text), generator=gen)
    prefix = torch.randn(B, n_img, cfg.d_model, generator=gen)
    whole = T._embed(params, tokens, cfg, prefix)
    assert torch.equal(T._embed_rows(params, tokens, cfg, prefix, lo, hi), whole[:, lo:hi])


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "worker.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests", "_dryrun_worker.py"),
                           str(out)], capture_output=True, text=True, timeout=900, env=env,
                          cwd=REPO)
    assert proc.returncode == 0 and "DRYRUN WORKER DONE" in proc.stdout, proc.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def test_mini_direction_accounting(worker):
    """``repro.testing.dryrun_check``'s property: Ring loads one direction,
    TokenRing both, and TokenRing's larger direction stays below Ring's."""
    ring, tok = worker["ring"], worker["tokenring"]
    assert ring["fwd"] > 0 and ring["bwd"] < 0.5 * ring["fwd"]
    assert tok["fwd"] > 0 and tok["bwd"] > 0
    assert min(tok["fwd"], tok["bwd"]) / max(tok["fwd"], tok["bwd"]) > 0.5
    assert max(tok["fwd"], tok["bwd"]) < 1.05 * ring["fwd"]
    for r in (ring, tok):  # every kernel call's positions resolved on rank 0
        assert r["unresolved"] == 0 and 0 < r["attention_flops"] < r["attention_flops_full"]


def test_run_cell_full_size(worker):
    cell = worker["cell"]
    assert cell["status"] == "ok" and cell["world"] == 256
    assert "llama2-7b" not in worker["sweep"]
    assert cell["memory"]["peak_bytes_per_device"] > cell["memory"]["argument_bytes_per_device"]
    assert cell["stats"]["attention_calls_unresolved"] == 0
    assert cell["roofline"]["bound_s"] > 0 and cell["plan"]["strategy"] == "tokenring"
