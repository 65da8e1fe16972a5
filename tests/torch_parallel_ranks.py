"""Rank bodies of the port's parallel tests, and the harness that runs them
in one gloo world of CPU processes.

This module imports only torch and the port, so the spawned ranks never
import jax; the tests (``tests/test_torch_parallel*.py``) compute the JAX
side in their own process. :func:`start_world` spawns ``world`` ranks
(``torch.multiprocessing``, spawn context, one intra-op thread each), each
of which joins a gloo world on a free localhost port, runs the named cases
in order on the inputs the test saved, and saves its results;
:meth:`World.results` joins them within a deadline (a hung collective
fails the test instead of stalling the suite) and returns one dict of
case results per rank.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from typing import Any, Dict, List

import torch
import torch.multiprocessing as mp

from autoawq_tpu_torch.api import AwqCausalLM
from autoawq_tpu_torch.config import AwqConfig
from autoawq_tpu_torch.io.hf import init_random_params
from autoawq_tpu_torch.nn import modules
from autoawq_tpu_torch.nn.fuse import tp_stack_qkv
from autoawq_tpu_torch.ops import moe_a2a, sharded_moe, tp_attn
from autoawq_tpu_torch.parallel import distributed as pd
from autoawq_tpu_torch.parallel import pipeline as pp
from autoawq_tpu_torch.parallel.mesh import build_mesh
from autoawq_tpu_torch.parallel.specs import param_decisions, shard_params
from autoawq_tpu_torch.quantize.quantizer import AwqQuantizer
from autoawq_tpu_torch.serve import generate as gen
from autoawq_tpu_torch.serve.batching import BatchingEngine
from autoawq_tpu_torch.train import lora as lora_mod

CPU = torch.device("cpu")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class World:
    def __init__(self, ctx, tmp: str, world: int, timeout: float):
        self.ctx, self.tmp, self.world = ctx, tmp, world
        self.deadline = time.time() + timeout
        self._results = None

    def results(self) -> List[Dict[str, Any]]:
        if self._results is None:
            while not self.ctx.join(timeout=max(0.1, self.deadline
                                                - time.time())):
                if time.time() >= self.deadline:
                    for p in self.ctx.processes:
                        p.kill()
                    raise TimeoutError("a rank of the gloo world did not "
                                       "finish in time")
            self._results = [torch.load(os.path.join(self.tmp, f"r{r}.pt"),
                                        weights_only=False)
                             for r in range(self.world)]
        return self._results


def start_world(world: int, cases: List[str], inputs: Dict[str, Any],
                timeout: float = 120.0) -> World:
    """Spawn the ranks without waiting for them (the caller computes the
    JAX side meanwhile)."""
    tmp = tempfile.mkdtemp(prefix="torch_parallel_")
    torch.save(inputs, os.path.join(tmp, "inputs.pt"))
    ctx = mp.start_processes(_rank_main, args=(world, _free_port(), cases,
                                               tmp),
                             nprocs=world, join=False, start_method="spawn")
    return World(ctx, tmp, world, timeout)


def _rank_main(rank: int, world: int, port: int, cases: List[str],
               tmp: str) -> None:
    torch.set_num_threads(1)
    pd.initialize(init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                  rank=rank, device="cpu")
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    out = {name: CASES[name](rank, inputs) for name in cases}
    torch.save(out, os.path.join(tmp, f"r{rank}.pt"))
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------- cases --

def _model(cfg, params) -> AwqCausalLM:
    """A model over a copy of the tree's containers (shard writes the
    qkv stack into its tree)."""
    return AwqCausalLM(cfg, _copy(params), device="cpu")


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree


def tp_forward(rank, inp):
    """Logits of ``forward`` at tensor 2 and 4 over every prompt, f32."""
    cfg, params = inp["tp_cfg"], inp["tp_params"]
    out = {}
    for t in (2, 4):
        mesh = build_mesh(tensor=t)
        m = _model(cfg, params).shard(mesh, dtype=None)
        for name, tokens in inp["tp_tokens"].items():
            out[(t, name)] = modules.forward(m.cfg, m.params, tokens,
                                             dtype=torch.float32)
    return out


def tree_shards(rank, inp):
    """This rank's tree at tensor 2 (and the decisions), for a model with
    ragged per-rank widths, the qkv stack and repacked zeros; and the
    refusal of tensor 4, whose KV heads do not divide, with the caller's
    tree left as it was."""
    cfg, params = inp["tree_cfg"], inp["tree_params"]
    mesh2 = build_mesh(tensor=2)
    full = _copy(params)
    tp_stack_qkv(cfg, full, 2)
    lcfg, local = shard_params(cfg, full, mesh2)
    logits = modules.forward(lcfg, local, inp["tree_tokens"],
                             dtype=torch.float32)
    mesh4 = build_mesh(tensor=4)
    m = _model(cfg, params)
    before = {k: sorted(v) for k, v in m.params["layers"][0].items()}
    try:
        m.shard(mesh4, dtype=None)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    after = {k: sorted(v) for k, v in m.params["layers"][0].items()}
    keep = {"layers": [{"self_attn": {
        k: {n: v for n, v in lin.items() if isinstance(v, torch.Tensor)}
        for k, lin in local["layers"][0]["self_attn"].items()},
        "mlp": {k: {n: v for n, v in lin.items()
                    if isinstance(v, torch.Tensor)}
                for k, lin in local["layers"][0]["mlp"].items()}}]}
    return {"local": keep, "logits": logits,
            "decisions": {t: param_decisions(cfg, params, t) for t in (2, 4)},
            "refusal": refusal, "untouched": before == after,
            "o_marker": sorted(k for k in local["layers"][0]["self_attn"][
                "o_proj"] if k.startswith("tp_"))}


def _prefill_decode(cfg, params, prompt, cap, method="auto"):
    caches = gen.init_kv_cache(cfg, prompt.shape[0], cap, torch.float32,
                               CPU)
    logits, caches = gen.prefill(cfg, params, prompt, caches, method,
                                 torch.float32)
    tok = logits.argmax(-1)[:, None]
    out, _ = gen.decode_step(cfg, params, tok, caches, prompt.shape[1],
                             method, torch.float32)
    return out


def tp_decode(rank, inp):
    """One decode step at B = 8 through K5's route on each rank's heads
    (the twin here), with its calls counted, at tensor 2 and 4."""
    cfg, params = inp["k5_cfg"], inp["k5_params"]
    calls = []
    orig = tp_attn.fused_attention_step_tp

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    tp_attn.fused_attention_step_tp = spy
    out = {"plain": _prefill_decode(cfg, params, inp["k5_prompt"], 64,
                                    "plain")}
    try:
        for t in (2, 4):
            m = _model(cfg, params).shard(build_mesh(tensor=t), dtype=None)
            out[t] = _prefill_decode(m.cfg, m.params, inp["k5_prompt"], 64)
    finally:
        tp_attn.fused_attention_step_tp = orig
    out["k5_calls"] = len(calls)
    return out


def tp_mlp(rank, inp):
    """The decode MLP through K8's route on each rank's slice (the twin
    here) plus the all-reduce, at tensor 2 and 4."""
    cfg, params = inp["tp_cfg"], inp["tp_params"]
    out = {}
    for t in (2, 4):
        lcfg, local = shard_params(cfg, params, build_mesh(tensor=t))
        p = local["layers"][0]["mlp"]
        assert "tp_psum" in p["down_proj"]
        x = inp["mlp_x"]
        assert modules._sharded_mlp_ok(lcfg, p, x, "auto",
                                       lcfg.intermediate_size)
        out[t] = modules.mlp(lcfg, p, x)
    return out


def tp_engine(rank, inp):
    """Greedy streams of the slot engine over TP parameters, burst 1 and
    4, at tensor 2 and 4."""
    cfg, params = inp["eng_cfg"], inp["eng_params"]
    out = {}
    for t in (2, 4):
        m = _model(cfg, params).shard(build_mesh(tensor=t), dtype=None)
        for burst in (1, 4):
            eng = BatchingEngine(m.cfg, m.params, max_batch=2,
                                 max_seq_len=48, dtype=torch.float32,
                                 device="cpu")
            for i, pr in enumerate(inp["eng_prompts"]):
                eng.add_request(i, pr, 8)
            out[(t, burst)] = eng.run(burst=burst)
    return out


def ep_ops(rank, inp):
    """The two expert-parallel schemes on an expert axis of 2, at the op
    level: replicate-and-sum over every token, and the all-to-all over this
    rank's tokens at each capacity factor."""
    mesh = build_mesh(expert=2)
    ax = mesh.axis("expert")
    st = inp["ep_stacked"]
    n = st["gate_up_proj"]["qweight"].shape[0] // 2
    local = {name: {k: v[ax.index * n:(ax.index + 1) * n].clone()
                    for k, v in lin.items()} for name, lin in st.items()}
    out = {"replicate": sharded_moe.moe_mlp_sharded(
        local, inp["ep_x"], inp["ep_topw"], inp["ep_topi"], "silu",
        inp["ep_inter"], ax).to(inp["ep_x"].dtype)}
    for name, (x, topw, topi, cf) in inp["ep_a2a"].items():
        tl = x.shape[0] // 2
        sl = slice(ax.index * tl, (ax.index + 1) * tl)
        y = moe_a2a.moe_mlp_a2a(local, x[sl], topw[sl], topi[sl], "silu",
                                inp["ep_inter"], ax, capacity_factor=cf)
        out[name] = pd.all_gather(y, ax, dim=0)
    return out


def ep_model(rank, inp):
    """Mixtral-style forwards through ``shard``: experts over ``expert``
    (both dispatch schemes), and attention over ``tensor`` with the experts
    replicated."""
    cfg, params = inp["moe_cfg"], inp["moe_params"]
    out = {}
    for scheme in ("replicate", "a2a"):
        m = _model(cfg, params).shard(build_mesh(expert=2), dtype=None,
                                      moe_dispatch=scheme)
        st = m.params["layers"][0]["mlp"]["experts_stacked"]
        assert st["ep_dispatch"] == scheme
        out[("expert", scheme)] = modules.forward(
            m.cfg, m.params, inp["moe_tokens"], dtype=torch.float32)
    m = _model(cfg, params).shard(build_mesh(tensor=2), dtype=None)
    out["tensor"] = modules.forward(m.cfg, m.params, inp["moe_tokens"],
                                    dtype=torch.float32)
    return out


def dp_calib(rank, inp):
    """AWQ calibration at data 4 and at data 2 (a tensor axis of 2 beside
    it), with the clip search off and on; the odd batch's fallback; the
    chunk sizes."""
    cfg = inp["dp_cfg"]
    params = init_random_params(cfg, seed=3, scale=0.08, device="cpu")
    qcfg = AwqConfig(q_group_size=32)
    calib = inp["dp_calib"]
    out = {}
    meshes = {4: build_mesh(data=4), 2: build_mesh(tensor=2, data=2)}
    for d, mesh in meshes.items():
        for clip in (False, True):
            q = AwqQuantizer(cfg, qcfg, params, calib, progress=False,
                             apply_clip=clip, mesh=mesh, device="cpu")
            res = q.quantize()
            out[(d, clip)] = {"tree": res,
                              "scales": [s for _, s in q.all_scales[0]]}
    odd = AwqQuantizer(cfg, qcfg, params, inp["dp_odd"], progress=False,
                       mesh=meshes[4], device="cpu")
    out["odd_falls_back"] = odd.mesh is None
    out["chunks"] = {
        (d, npar): AwqQuantizer(cfg, qcfg, params, calib, progress=False,
                                mesh=meshes[d], device="cpu",
                                n_parallel_calib_samples=npar
                                )._chunk_size(8)
        for d in (2, 4) for npar in (2, 4, 6)}
    # chunked and data-parallel compose: the same tree as unchunked
    q = AwqQuantizer(cfg, qcfg, params, calib, progress=False,
                     apply_clip=False, mesh=meshes[2], device="cpu",
                     n_parallel_calib_samples=4)
    out["chunked"] = q.quantize()
    return out


def _where(mesh) -> Dict[str, int]:
    return {a: mesh.index(a) for a in mesh.axis_names}


def _lora_leaves(tree, prefix=""):
    """The adapter leaves of a tree, detached, by dotted path."""
    if isinstance(tree, list):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, (dict, list)):
            out.update(_lora_leaves(v, path))
        elif k.startswith("lora_"):
            out[path] = v.detach().clone()
    return out


def meshes(rank, inp):
    """``build_mesh(pipe=2)``'s axes, coordinates and neighbours, and
    ``hybrid_mesh``'s shapes, coordinates and errors with
    ``LOCAL_WORLD_SIZE`` = 2 (two nodes of two ranks)."""
    out = {}
    for kw in (dict(pipe=2), dict(pipe=2, tensor=2), dict(pipe=4)):
        mesh = build_mesh(**kw)
        out[tuple(sorted(kw.items()))] = {
            "axes": mesh.axis_names, "shape": dict(mesh.shape),
            "coords": dict(mesh.coords),
            "pipe": mesh.neighbours("pipe"),
            "sum": pd.all_reduce(torch.ones(1), mesh.axis("pipe")).item()}
    old = os.environ.get("LOCAL_WORLD_SIZE")
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    try:
        hy = {}
        for kw in (dict(tensor=2), dict(expert=2),
                   dict(tensor=2, dcn_data=1), dict(tensor=1)):
            mesh = pd.hybrid_mesh(**kw)
            hy[tuple(sorted(kw.items()))] = {
                "axes": mesh.axis_names, "shape": dict(mesh.shape),
                "coords": dict(mesh.coords),
                "data_sum": pd.all_reduce(torch.ones(1),
                                          mesh.axis("data")).item()}
        errors = []
        for kw in (dict(tensor=2, expert=2), dict(tensor=3),
                   dict(tensor=2, ici_data=2)):
            try:
                pd.hybrid_mesh(**kw)
                errors.append(None)
            except ValueError as e:
                errors.append(str(e))
        out["hybrid"], out["hybrid_errors"] = hy, errors
    finally:
        if old is None:
            del os.environ["LOCAL_WORLD_SIZE"]
        else:
            os.environ["LOCAL_WORLD_SIZE"] = old
    return out


def pp_forward(rank, inp):
    """``pipeline_forward`` logits of each case on its mesh, at each
    microbatch count; whether the caller's tree kept its fused LINs."""
    out = {}
    for name, case in inp["pp_forward"].items():
        cfg, params = case["cfg"], case["params"]
        mesh = build_mesh(**case["mesh"])
        pparams = pp.to_pipeline(cfg, params, mesh, device="cpu")
        for m in case["microbatches"]:
            out[(name, m)] = pp.pipeline_forward(
                cfg, pparams, case["tokens"], mesh, m, dtype=torch.float32)
        out[(name, "fused_kept")] = "qkv_proj" in params["layers"][0][
            "self_attn"]
    return out


def pp_lora(rank, inp):
    """One ``pipeline_lora_step`` of each case: the loss and this rank's
    updated adapters, with its coordinates."""
    out = {}
    for name, case in inp["pp_lora"].items():
        cfg = case["cfg"]
        mesh = build_mesh(**case["mesh"])
        pparams = pp.to_pipeline(cfg, _copy_tensors(case["params"]), mesh,
                                 device="cpu")
        lora, base = lora_mod.split_lora(pparams)
        loss, new = pp.pipeline_lora_step(cfg, lora, base, case["tokens"],
                                          mesh, 2, lr=1e-2,
                                          dtype=torch.float32)
        out[name] = {"loss": loss.item(), "where": _where(mesh),
                     "adapters": _lora_leaves(new)}
    return out


def pp_refusals(rank, inp):
    """What ``to_pipeline`` and ``pipeline_forward`` refuse, with their
    messages, and whether the caller's tree is as it was."""
    out = {}
    mesh = build_mesh(pipe=2, tensor=2)
    for name, (cfg, params) in inp["pp_refuse"].items():
        before = {k: sorted(v) for k, v in params["layers"][0].items()}
        try:
            pp.to_pipeline(cfg, params, mesh, device="cpu")
            err = None
        except (ValueError, NotImplementedError) as e:
            err = (type(e).__name__, str(e))
        after = {k: sorted(v) for k, v in params["layers"][0].items()}
        out[name] = {"error": err, "untouched": before == after}
    cfg, params = inp["pp_forward"]["dense"]["cfg"], \
        inp["pp_forward"]["dense"]["params"]
    mesh = build_mesh(pipe=2, data=2)
    pparams = pp.to_pipeline(cfg, params, mesh, device="cpu")
    for name, (tokens, m) in (("microbatches", (torch.zeros(4, 8,
                                                            dtype=torch.long),
                                                3)),
                              ("data", (torch.zeros(2, 8, dtype=torch.long),
                                        2))):
        try:
            pp.pipeline_forward(cfg, pparams, tokens, mesh, m)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def tp_breadth(rank, inp):
    """Flat tensor 2 of the trees the port once refused: an ALiBi MPT, an MLA +
    MoE DeepSeek-V2 (the forward, a prefill and one decode step through
    ``shard``), and a LoRA tree (one ``lora_train_step`` on the rank's
    shards, and the adapters' gradients)."""
    out = {}
    mesh = build_mesh(tensor=2)
    for name in ("mpt", "mla"):
        cfg, params = inp[f"{name}_cfg"], inp[f"{name}_params"]
        m = _model(cfg, params).shard(mesh, dtype=None)
        out[(name, "forward")] = modules.forward(
            m.cfg, m.params, inp[f"{name}_tokens"], dtype=torch.float32)
        out[(name, "decode")] = _prefill_decode(m.cfg, m.params,
                                                inp[f"{name}_prompt"], 64)
        out[(name, "cfg")] = (m.cfg.num_attention_heads,
                              getattr(m.cfg, "head_offset", None))
    cfg = inp["lora_cfg"]
    lcfg, local = shard_params(cfg, _copy_tensors(inp["lora_params"]), mesh)
    lora, base = lora_mod.split_lora(local)
    _, grads = lora_mod.lora_loss_and_grads(lcfg, lora, base,
                                            inp["lora_tokens"],
                                            dtype=torch.float32)
    paths = list(_lora_leaves(lora))
    out["lora_grads"] = dict(zip(paths, [g.clone() for g in grads]))
    loss, new = lora_mod.lora_train_step(lcfg, lora, base,
                                         inp["lora_tokens"], lr=1e-2,
                                         dtype=torch.float32)
    out["lora_step"] = {"loss": loss.item(), "adapters": _lora_leaves(new)}
    out["pair"] = _pair_grads(mesh.axis("tensor"))
    return out


def _pair_grads(ax):
    """The three autograd collectives on small seeded operands: the
    gradient a rank's piece of an all-gathered input gets, the gradient of
    a replicated input to the rank's columns (Megatron's f), and the sum
    of the rank's row partials with its input's gradient (g)."""
    g = torch.Generator().manual_seed(7)
    x, w = torch.randn(3, 8, generator=g), torch.randn(8, 6, generator=g)
    c = torch.randn(3, 6, generator=g)
    rows, cols = slice(4 * ax.index, 4 * ax.index + 4), \
        slice(3 * ax.index, 3 * ax.index + 3)
    xg = x[:, rows].clone().requires_grad_()
    (pd.gather_from_tensor(xg, ax) @ w * c).sum().backward()
    xc = x.clone().requires_grad_()
    (pd.copy_to_tensor(xc, ax) @ w[:, cols] * c[:, cols]).sum().backward()
    xr = x[:, rows].clone().requires_grad_()
    y = pd.reduce_from_tensor(xr @ w[rows], ax)
    (y * c).sum().backward()
    return {"gather": xg.grad, "copy": xc.grad, "reduce": xr.grad,
            "reduce_y": y.detach(), "x": x, "w": w, "c": c}


def sp_forward(rank, inp):
    """``forward`` at tensor 4 with sequence parallelism
    (``sequence_parallel=mesh.axis("tensor")``) and without, for each
    case, f32, with the reduce-scatters the SP run made."""
    out = {}
    mesh = build_mesh(tensor=4)
    ax = mesh.axis("tensor")
    calls = []
    real = pd.reduce_scatter

    def counted(t, axis, dim=0):
        calls.append(tuple(t.shape))
        return real(t, axis, dim)

    pd.reduce_scatter = counted
    try:
        for name, case in inp["sp"].items():
            m = _model(case["cfg"], case["params"]).shard(mesh, dtype=None)
            with torch.no_grad():
                del calls[:]
                sp = modules.forward(m.cfg, m.params, case["tokens"],
                                     dtype=torch.float32,
                                     sequence_parallel=ax)
                scatters = list(calls)
                tp = modules.forward(m.cfg, m.params, case["tokens"],
                                     dtype=torch.float32)
            out[name] = {"sp": sp, "tp": tp, "scatters": scatters}
    finally:
        pd.reduce_scatter = real
    return out


def pp_mla_lora(rank, inp):
    """One ``pipeline_lora_step`` on MLA stages at pipe 2 x tensor 2: the
    loss and this rank's updated adapters (``pp_lora``'s layout)."""
    case = inp["pp_mla"]
    cfg = case["cfg"]
    mesh = build_mesh(pipe=2, tensor=2)
    pparams = pp.to_pipeline(cfg, _copy_tensors(case["params"]), mesh,
                             device="cpu")
    lora, base = lora_mod.split_lora(pparams)
    loss, new = pp.pipeline_lora_step(cfg, lora, base, case["tokens"], mesh,
                                      2, lr=1e-2, dtype=torch.float32)
    return {"loss": loss.item(), "where": _where(mesh),
            "adapters": _lora_leaves(new)}


def pp_moe_refusal(rank, inp):
    """``pipeline_lora_step`` on MoE stages whose experts split over
    tensor (``tp_ep``): the error on every rank, before any transfer."""
    case = inp["pp_moe"]
    cfg = case["cfg"]
    mesh = build_mesh(pipe=2, tensor=2)
    pparams = pp.to_pipeline(cfg, _copy_tensors(case["params"]), mesh,
                             device="cpu")
    lora, base = lora_mod.split_lora(pparams)
    try:
        pp.pipeline_lora_step(cfg, lora, base, case["tokens"], mesh, 2,
                              dtype=torch.float32)
        return None
    except NotImplementedError as e:
        return str(e)


def _copy_tensors(tree):
    if isinstance(tree, dict):
        return {k: _copy_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tensors(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


CASES = {f.__name__: f for f in (tp_forward, tree_shards, tp_decode, tp_mlp,
                                 tp_engine, ep_ops, ep_model, dp_calib,
                                 meshes, pp_forward, pp_lora, pp_refusals,
                                 tp_breadth, sp_forward, pp_mla_lora,
                                 pp_moe_refusal)}
