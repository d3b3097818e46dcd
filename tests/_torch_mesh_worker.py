"""One rank of a gloo group for ``tests/test_torch_multidevice.py``.

  python tests/_torch_mesh_worker.py RANK WORLD STORE OUTDIR [pipeline]

Rendezvous through a ``FileStore`` at STORE, a 60 s collective timeout;
the rank writes its readings to OUTDIR/rank<RANK>.json, which the test
holds to its limits. Every rank also computes the one-process reference
(every rank holds the whole model), so a reading is a gap between the
sharded run and the unsharded one on the same inputs.
"""

import contextlib
import dataclasses
import datetime
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core import flags
from repro_torch.core import tree as tu
from repro_torch.core.config import Activation, GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.data import (SyntheticLM, SyntheticLMConfig, make_batch,
                              make_global_batch)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps
from repro_torch.optim import adamw

F32 = GemminiConfig(input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")
LR = 1e-3
BATCH, SEQ = 4, 32
FAMILIES = ("mamba2-1.3b", "granite-moe-3b-a800m")


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / max(den, 1e-30)


def full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


class ShapeMesh:
    """A shape-only stand-in of ``mesh`` (``launch.mesh`` reads its axis
    sizes): the one-process reference of the grouped MoE dispatch groups
    its tokens by it as the sharded run does."""

    def __init__(self, mesh):
        self.axis_names = tuple(mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, mesh.shape))


def check_train(mesh, arch="gemma3-1b", *, grad_accum=1, grouped=False,
                save=None):
    """Two sharded train steps against two one-process steps (the same
    ``grad_accum``; ``grouped``: the MoE's grouped dispatch on, the
    reference grouped by a stand-in of ``mesh``). ``save``: a path for
    the initial parameters, the first batch and the first sharded step's
    loss, gradient norm and parameters (the JAX step's inputs and
    readings in ``tests/test_torch_multidevice.py``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype=torch.float32)
    ctx = ExecutionContext(cfg=F32)
    sctx = ctx.with_mesh(mesh, shd.data_axis(mesh))
    opt = adamw.AdamWConfig(lr=LR)
    gen = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq=SEQ,
                                        global_batch=BATCH, seed=3))
    tspec = shd.tokens_spec(mesh, BATCH)
    ref = steps.init_train_state(cfg, seed=3, device="cpu")
    st = steps.init_train_state(cfg, seed=3, device="cpu", mesh=mesh)
    old = dict(tu.flatten_with_paths(ref.params))
    def ref_mesh():
        return mesh_lib.activate_mesh(ShapeMesh(mesh)) if grouped \
            else contextlib.nullcontext()
    flags.set_flag("moe_grouped_dispatch", int(grouped))

    b0 = make_batch(gen, 0, "cpu")
    g0 = make_global_batch(gen, 0, mesh, tspec)
    try:
        with implicit_replication():
            with ref_mesh():
                lr_, gr = steps.loss_and_grads(ctx, cfg, ref.params, b0,
                                               grad_accum=grad_accum)
            with mesh_lib.activate_mesh(mesh):
                ls, gs = steps.loss_and_grads(
                    sctx, cfg, st.params, g0, grad_accum=grad_accum,
                    **steps.layouts(cfg, mesh, BATCH // grad_accum, SEQ))
        grad_rel = {p: rel_l2(full(g), dict(tu.flatten_with_paths(gr))[p])
                    for p, g in tu.flatten_with_paths(gs)}
        ref_step = steps.make_train_step(ctx, cfg, opt,
                                         grad_accum=grad_accum)
        sh_step = steps.make_train_step(sctx, cfg, opt, mesh,
                                        grad_accum=grad_accum)
        losses = []
        for i in range(2):
            with ref_mesh():
                ref, rm = ref_step(ref, make_batch(gen, i, "cpu"))
            st, sm = sh_step(st, make_global_batch(gen, i, mesh, tspec))
            losses.append([float(sm["loss"]), float(rm["loss"]),
                           float(sm["grad_norm"]), float(rm["grad_norm"])])
            if save and i == 0 and dist.get_rank() == 0:
                np.savez(save, tokens=b0["tokens"].numpy(),
                         loss=float(sm["loss"]),
                         grad_norm=float(sm["grad_norm"]),
                         **{"init/" + p: v.numpy() for p, v in old.items()},
                         **{"step/" + p: full(v).numpy() for p, v in
                            tu.flatten_with_paths(st.params)})
    finally:
        flags.reset()
    new_ref = dict(tu.flatten_with_paths(ref.params))
    gap = {p: float(((full(x) - new_ref[p]).abs() / (
        2 * LR * (1 + opt.weight_decay * old[p].abs()))).max())
        for p, x in tu.flatten_with_paths(st.params)}
    layouts = {p: [str(q) for q in x.placements]
               for p, x in tu.flatten_with_paths(st.opt["m"])}
    return {"loss0": [float(full(ls)), float(lr_)], "grad_rel": grad_rel,
            "steps": losses, "param_gap": gap, "m_layouts": layouts}


def check_ops(mesh):
    """Every op of the sharded context against the unsharded call on the
    same whole inputs: int8 GEMM / conv bit for bit, the float ops within
    1e-6 of the largest magnitude. ``rows`` odd: the batch does not
    divide, and the call runs whole; dense decode and paged prefill are
    never split."""
    from torch.distributed.tensor import Replicate
    out = {}
    g = torch.Generator().manual_seed(11)
    whole = [Replicate()] * mesh.ndim

    def dt(x):
        from torch.distributed.tensor import DTensor
        return None if x is None else DTensor.from_local(
            x, mesh, whole, run_check=False)

    def hold(name, fn, args, exact):
        want = fn(ExecutionContext(cfg=cfg), *args)
        got = fn(ExecutionContext(cfg=cfg).with_mesh(
            mesh, shd.data_axis(mesh)), *[dt(a) for a in args])
        wants = want if isinstance(want, tuple) else (want,)
        gots = got if isinstance(got, tuple) else (got,)
        errs = []
        for w, x in zip(wants, gots):
            x = full(x)
            scale = float(w.double().abs().max()) or 1.0
            errs.append(float((x.double() - w.double()).abs().max()) / scale)
            if exact:
                errs[-1] = 0.0 if torch.equal(x, w) else max(errs[-1], 1.0)
        out[name] = max(errs)

    cfg = GemminiConfig()           # int8 -> int32 -> int8
    for rows in (8, 7):
        a = torch.randint(-128, 128, (rows, 96), generator=g,
                          dtype=torch.int8)
        b = torch.randint(-128, 128, (96, 40), generator=g, dtype=torch.int8)
        d = torch.randint(-3000, 3000, (1, 40), generator=g,
                          dtype=torch.int32)
        hold(f"gemm_int8_bias_rows{rows}",
             lambda c, a, b, d: c.gemm(a, b, d, shift=6,
                                       activation=Activation.RELU),
             (a, b, d), True)
    x = torch.randint(-128, 128, (4, 9, 9, 8), generator=g, dtype=torch.int8)
    w = torch.randint(-128, 128, (3, 3, 8, 16), generator=g,
                      dtype=torch.int8)
    bias = torch.randint(-500, 500, (16,), generator=g, dtype=torch.int32)
    for fused in (False, True):
        hold(f"conv2d_int8_fused{int(fused)}",
             lambda c, x, w, b: c.conv2d(x, w, b, stride=2, padding=1,
                                         shift=5, fused=fused,
                                         activation=Activation.RELU),
             (x, w, bias), True)
    cfg = F32
    hold("matmul_fp32", lambda c, a, b: c.matmul(a, b),
         (torch.randn((4, 6, 32), generator=g),
          torch.randn((32, 24), generator=g)), False)
    q = torch.randn((4, 16, 4, 16), generator=g)
    k = torch.randn((4, 16, 2, 16), generator=g)
    v = torch.randn((4, 16, 2, 16), generator=g)
    hold("flash_attention_fp32",
         lambda c, q, k, v: c.flash_attention(q, k, v, window=8), (q, k, v),
         False)
    pool_k = torch.randn((2, 9, 4, 16), generator=g)
    pool_v = torch.randn((2, 9, 4, 16), generator=g)
    tables = torch.randint(0, 8, (4, 3), generator=g, dtype=torch.int32)
    lengths = torch.tensor([5, 12, 1, 9], dtype=torch.int32)
    hold("paged_attention_fp32",
         lambda c, q, kp, vp, t, n: c.paged_attention(q, kp, vp, t, n),
         (q[:, :1], pool_k, pool_v, tables, lengths), False)
    # not split (as in JAX): whole operands on every rank
    hold("decode_attention_fp32",
         lambda c, q, k, v: c.decode_attention(q, k, v, 11), (q[:, :1], k, v),
         False)
    hold("paged_prefill_attention_fp32",
         lambda c, q, kp, vp, t: c.paged_prefill_attention(q, kp, vp, t, 4),
         (q[:1, :8], pool_k, pool_v, tables[0]), False)
    xs = torch.randn((4, 32, 4, 8), generator=g)
    dts = torch.nn.functional.softplus(torch.randn((4, 32, 4), generator=g))
    a_log = torch.randn((4,), generator=g)
    bs = torch.randn((4, 32, 1, 8), generator=g)
    cs = torch.randn((4, 32, 1, 8), generator=g)
    init = torch.randn((4, 4, 8, 8), generator=g)
    hold("ssd_fp32_resumed",
         lambda c, x, d, a, b, cc, i: c.ssd(x, d, a, b, cc, chunk=16,
                                            initial_state=i,
                                            return_final_state=True),
         (xs, dts, a_log, bs, cs, init), False)
    return out


MOE_KW = dict(n_experts=4, top_k=2, capacity_factor=64.0)
PP_L, PP_D, PP_MICRO, PP_MB = 8, 32, 6, 4


def moe_inputs():
    """The MoE layer of ``tests/test_perf_flags.py``'s grouped-dispatch
    case (d 16, ff 8, 4 experts; x 4 x 16 x 16), fp32 numbers from a
    seed: the JAX reference draws the same."""
    rng = np.random.default_rng(7)
    d, ff, e = 16, 8, 4
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "wi": rng.standard_normal((e, d, ff)) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, ff)) / np.sqrt(d),
         "wo": rng.standard_normal((e, ff, d)) / np.sqrt(ff)}
    x = rng.standard_normal((4, 16, 16))
    return ({k: v.astype(np.float32) for k, v in p.items()},
            x.astype(np.float32))


def check_moe_grouped(mesh, save):
    """``moe_apply`` on DTensors (x in the residual layout, the weights
    in ``param_specs``) with the grouped dispatch off and on: output and
    gradients (x and every weight, of sum(y^2)); the grouped output saved
    for the JAX reference."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import moe
    p_np, x_np = moe_inputs()
    sctx = ExecutionContext(cfg=F32).with_mesh(mesh, shd.data_axis(mesh))

    def run(grouped):
        pt = {"moe": {k: torch.from_numpy(v) for k, v in p_np.items()}}
        pd = shd.distribute_tree(pt, shd.param_specs(pt, mesh), mesh)
        leaves = [v.requires_grad_(True) for v in tu.leaves(pd)]
        xd = shd.distribute(torch.from_numpy(x_np),
                            shd.P("data", "model", None),
                            mesh).requires_grad_(True)
        flags.set_flag("moe_grouped_dispatch", int(grouped))
        try:
            with implicit_replication(), mesh_lib.activate_mesh(mesh):
                y = moe.moe_apply(sctx, pd["moe"], xd, **MOE_KW)
                (y ** 2).sum().backward()
        finally:
            flags.reset()
        return full(y).detach(), [full(xd.grad)] + [full(v.grad)
                                                    for v in leaves]

    y0, g0 = run(False)
    y1, g1 = run(True)
    if dist.get_rank() == 0:
        np.savez(save, y=y1.numpy())
    names = ["x"] + [p for p, _ in tu.flatten_with_paths(p_np)]
    return {"y_max_abs": float((y1 - y0).abs().max()),
            "grad_rel": {n: rel_l2(a, b) for n, a, b in zip(names, g1, g0)}}


def pp_inputs():
    """JAX's pipeline case (``tests/test_sharding_dryrun.py``): L 8
    tanh layers of D 32, 6 micro-batches of 4, the same draws."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((PP_L, PP_D, PP_D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((PP_MICRO, PP_MB, PP_D)).astype(np.float32)
    return w, x


def tanh_stage(wp, h):
    for i in range(wp.shape[0]):
        h = torch.tanh(h @ wp[i])
    return h


def check_pipeline(mesh, save):
    """The GPipe loop over ``stage`` (and, on a (stage, data) mesh, the
    micro-batch rows split over ``data``): output and the stacked
    weights' gradient of sum(y^2) against the layers applied in turn to
    each micro-batch in one process; rank 0 saves both for the JAX
    reference."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.pipeline import pipeline_apply, split_stages
    w_np, x_np = pp_inputs()
    n_stages = mesh_lib.axis_size(mesh, "stage")
    stages = shd.distribute(split_stages(torch.from_numpy(w_np), n_stages),
                            shd.P("stage"), mesh).requires_grad_(True)
    x = torch.from_numpy(x_np)
    if "data" in mesh.mesh_dim_names:
        sub = mesh["data"]
        x = DTensor.from_local(x, sub, [Replicate()], run_check=False
                               ).redistribute(sub, [Shard(1)])
    with implicit_replication():
        y = pipeline_apply(tanh_stage, stages, x, mesh=mesh)
        (full(y) ** 2).sum().backward()
    g = stages.grad.full_tensor().reshape(PP_L, PP_D, PP_D)
    w = torch.from_numpy(w_np).requires_grad_(True)
    ref = torch.stack([tanh_stage(w, xi) for xi in torch.from_numpy(x_np)])
    (ref ** 2).sum().backward()
    y = full(y).detach()
    if dist.get_rank() == 0:
        np.savez(save, y=y.numpy(), g=g.numpy())
    return {"y_max_abs": float((y - ref.detach()).abs().max()),
            "g_max_abs": float((g - w.grad).abs().max()),
            "shape": list(mesh.shape)}


def check_repaired_ops(mesh):
    """The ops DTensor cannot propagate on torch 2.11 (ROADMAP C9), on
    DTensors split along the op's dim, against the plain ops on the whole
    tensors: outputs and gradients bit for bit. ``local_along``: the pad
    of blockwise attention's keys and the SSD's chunks, and the SSD's
    cumulative sum (whose backward flips); ``replicated_call``: the MoE
    dispatch's scatter (index_put_) and its gather."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.core import dtensor as shard
    g = torch.Generator().manual_seed(5)
    x = torch.randn((4, 6, 3, 2), generator=g)
    slot = torch.randint(0, 9, (8,), generator=g)
    rows = torch.randn((8, 5), generator=g)
    split = (Shard(1),) + (Replicate(),) * (mesh.ndim - 1)
    by_rows = (Shard(0),) + (Replicate(),) * (mesh.ndim - 1)
    cases = {
        "pad": (lambda v: shard.local_along(lambda t: torch.nn.functional.pad(
            t, (0, 0, 0, 0, 0, 2)), v, 1), (x,), split),
        "cumsum": (lambda v: shard.local_along(
            lambda t: torch.cumsum(t, dim=1), v, 1), (x,), split),
        "scatter": (lambda s, r: shard.replicated_call(
            lambda s, r: r.new_zeros((10, 5)).index_put((s,), r), s, r),
            (slot, rows), by_rows),
        "gather": (lambda s, r: shard.replicated_call(
            lambda s, r: r[s.clamp(max=6)], s, r), (slot, rows), by_rows),
    }
    out = {}
    for name, (fn, args, pl) in cases.items():
        plain = [a.clone().requires_grad_(a.is_floating_point())
                 for a in args]
        want = fn(*plain)
        w = torch.randn(want.shape, generator=g)
        (want * w).sum().backward()
        dts = [shd.distribute(a, shd.from_placements(pl, mesh, a.ndim),
                              mesh).requires_grad_(a.is_floating_point())
               for a in args]
        with implicit_replication():
            got = fn(*dts)
            (got * w).sum().backward()
        same = torch.equal(full(got), want) and all(
            torch.equal(full(d.grad), p.grad) for d, p in zip(dts, plain)
            if p.requires_grad)
        out[name] = bool(same)
    return out


def check_batch(mesh):
    """``make_global_batch`` against ``make_batch``, tokens and the VLM
    stub's embeddings."""
    gen = SyntheticLM(SyntheticLMConfig(vocab=500, seq=24, global_batch=8,
                                        seed=5))
    got = make_global_batch(gen, 3, mesh, shd.tokens_spec(mesh, 8),
                            extra_embed_dim=12, extra_tokens=5)
    want = make_batch(gen, 3, "cpu", extra_embed_dim=12, extra_tokens=5)
    return {k: bool(torch.equal(full(got[k]), want[k])) for k in want} | {
        "tokens_local_rows": int(got["tokens"].to_local().shape[0])}


def check_elastic(outdir, rank):
    """Save a tree laid out on one mesh, restore it onto another: (4, 1)
    to (1, 4), and (2, 2) to (2, 2) in another layout; then onto whole
    tensors in one process's layout. Bit for bit (bf16 and fp32)."""
    from torch.distributed.tensor import DTensor
    g = torch.Generator().manual_seed(9)
    tree = {"w": torch.randn((8, 12), generator=g).to(torch.bfloat16),
            "blocks": {"v": torch.randn((4, 8, 12), generator=g)},
            "count": torch.tensor(7, dtype=torch.int32)}
    res = {}
    cases = {"4x1_to_1x4": ((4, 1), (1, 4),
                            {"w": shd.P("data", "model"),
                             "v": shd.P(None, "data", None)},
                            {"w": shd.P("model", None),
                             "v": shd.P("model", None, None)}),
             "2x2_to_2x2": ((2, 2), (2, 2),
                            {"w": shd.P("data", "model"),
                             "v": shd.P("model", "data", None)},
                            {"w": shd.P("model", "data"),
                             "v": shd.P(None, None, ("data", "model"))})}
    for name, (src, dst, s_specs, d_specs) in cases.items():
        ckpt = os.path.join(outdir, f"ckpt_{name}")
        m_src = mesh_lib.make_mesh(src, ("data", "model"), "cpu")
        m_dst = mesh_lib.make_mesh(dst, ("data", "model"), "cpu")
        saved = {"w": shd.distribute(tree["w"], s_specs["w"], m_src),
                 "blocks": {"v": shd.distribute(tree["blocks"]["v"],
                                                s_specs["v"], m_src)},
                 "count": tree["count"]}
        save_checkpoint(ckpt, 1, saved, {"case": name})
        target = {"w": shd.distribute(torch.zeros_like(tree["w"]),
                                      d_specs["w"], m_dst),
                  "blocks": {"v": shd.distribute(
                      torch.zeros_like(tree["blocks"]["v"]), d_specs["v"],
                      m_dst)},
                  "count": torch.zeros((), dtype=torch.int32)}
        back = restore_checkpoint(ckpt, 1, target)
        ok = all(torch.equal(full(a), b) for a, b in
                 zip(tu.leaves(back), tu.leaves(tree)))
        layout_kept = all(
            isinstance(x, DTensor) and x.placements == t.placements
            for x, t in ((back["w"], target["w"]),
                         (back["blocks"]["v"], target["blocks"]["v"])))
        plain = restore_checkpoint(ckpt, 1, tree)
        ok_plain = all(torch.equal(a, b) for a, b in
                       zip(tu.leaves(plain), tu.leaves(tree)))
        files = sorted(f for f in os.listdir(os.path.join(
            ckpt, "step_00000001")))
        res[name] = {"equal": ok, "layout_kept": layout_kept,
                     "plain_equal": ok_plain, "files": files}
        dist.barrier()
    return res


def check_pipeline_model(mesh):
    """Smoke gemma3-1b at 6 layers (5 windowed, the 6th global) through
    ``pipeline_loss_fn`` over 2 stages, 2 micro-batches of 2 x 16 tokens
    (longer than the window): the loss and every gradient leaf against
    ``transformer.loss_fn`` on the whole batch in one process. Stage 1
    runs layers 3-5 with their own windows, or the global layer's output
    would differ."""
    from repro_torch.launch import pipeline as pp
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(configs.get_smoke("gemma3-1b"), n_layers=6,
                              dtype=torch.float32)
    ctx = ExecutionContext(cfg=F32)
    params = tf.init_params(torch.Generator().manual_seed(6), cfg)
    toks = torch.randint(0, cfg.vocab, (4, 16),
                         generator=torch.Generator().manual_seed(7))
    ref = {k: v for k, v in params.items()}
    leaves = [v.requires_grad_(True) for v in tu.leaves(ref)]
    want = tf.loss_fn(ctx, ref, cfg, toks, toks)
    want.backward()
    n_stages = mesh_lib.axis_size(mesh, "stage")
    stages = tu.tree_map(
        lambda v: shd.distribute(v.detach(), shd.P("stage"), mesh)
        .requires_grad_(True), pp.split_stages(params["blocks"], n_stages))
    rest = {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items() if k != "blocks"}
    loss_fn = pp.pipeline_loss_fn(*pp.transformer_stage_fns(ctx, cfg, mesh))
    got = loss_fn(dict(rest, stages=stages), toks, toks, mesh=mesh,
                  n_micro=2)
    got.backward()
    grads = dict(tu.flatten_with_paths(
        {k: v.grad for k, v in params.items() if k != "blocks"}))
    got_g = dict(tu.flatten_with_paths({k: v.grad for k, v in rest.items()}))
    got_g.update({"blocks/" + p: v.grad.full_tensor().reshape(
        -1, *v.shape[2:]) for p, v in tu.flatten_with_paths(stages)})
    grads.update({"blocks/" + p: v.grad for p, v in
                  tu.flatten_with_paths(params["blocks"])})
    return {"loss": [float(got), float(want)],
            "grad_rel": {p: rel_l2(got_g[p], g) for p, g in grads.items()}}


def run_pipelines(world, outdir):
    """The stage loop on a (world,) ``stage`` mesh and, at world 4, on a
    (2, 2) (stage, data) mesh."""
    out = {"stage": check_pipeline(
        mesh_lib.make_mesh((world,), ("stage",), "cpu"),
        os.path.join(outdir, "pipeline.npz"))}
    if world == 2:
        out["model"] = check_pipeline_model(
            mesh_lib.make_mesh((2,), ("stage",), "cpu"))
    if world == 4:
        out["stage_data"] = check_pipeline(
            mesh_lib.make_mesh((2, 2), ("stage", "data"), "cpu"),
            os.path.join(outdir, "pipeline_stage_data.npz"))
        m3 = mesh_lib.make_mesh((2, 2, 1), ("stage", "data", "model"),
                                "cpu")
        out["mesh_3d"] = {"axes": list(mesh_lib.axis_names(m3)),
                          "dp": mesh_lib.dp_size(m3),
                          "tp": mesh_lib.tp_size(m3),
                          "stage": mesh_lib.axis_size(m3, "stage")}
    return out


def run_mesh(res, world, outdir, rank):
    """The (2, world / 2) (data, model) mesh's checks into ``res``."""
    shape = (2, world // 2)
    mesh = mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
    res["mesh"] = list(shape)
    res["train"] = check_train(mesh)
    if world == 2:        # the recurrent and MoE blocks on DTensors
        res["train_families"] = {a: check_train(mesh, a) for a in
                                 FAMILIES}
        res["train_accum"] = check_train(
            mesh, grad_accum=2, save=os.path.join(outdir, "accum.npz"))
    if world == 4:        # the grouped dispatch, regroup over model
        res["moe_grouped"] = check_moe_grouped(
            mesh, os.path.join(outdir, "moe_grouped.npz"))
        res["train_grouped"] = check_train(
            mesh, "granite-moe-3b-a800m", grouped=True)
    res["ops"] = check_ops(mesh)
    res["repaired"] = check_repaired_ops(mesh)
    res["batch"] = check_batch(mesh)
    if world == 4:
        res["elastic"] = check_elastic(outdir, rank)


def main():
    rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    mode = sys.argv[5] if len(sys.argv) > 5 else "mesh"
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    res = {}
    try:
        if mode == "pipeline":
            res["pipeline"] = run_pipelines(world, outdir)
        else:
            run_mesh(res, world, outdir, rank)
    except Exception:                              # reported to the test
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
    sys.exit(1 if "error" in res else 0)


if __name__ == "__main__":
    main()
