"""One rank of a gloo group for ``tests/test_torch_multidevice.py``.

  python tests/_torch_mesh_worker.py RANK WORLD STORE OUTDIR

Rendezvous through a ``FileStore`` at STORE, a 60 s collective timeout;
the rank writes its readings to OUTDIR/rank<RANK>.json, which the test
holds to its limits. Every rank also computes the one-process reference
(every rank holds the whole model), so a reading is a gap between the
sharded run and the unsharded one on the same inputs.
"""

import dataclasses
import datetime
import json
import os
import sys
import traceback

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
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


def check_train(mesh, arch="gemma3-1b"):
    """Two sharded train steps against two one-process steps."""
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

    b0 = make_batch(gen, 0, "cpu")
    g0 = make_global_batch(gen, 0, mesh, tspec)
    with implicit_replication():
        lr_, gr = steps.loss_and_grads(ctx, cfg, ref.params, b0)
        ls, gs = steps.loss_and_grads(
            sctx, cfg, st.params, g0,
            **steps.layouts(cfg, mesh, BATCH, SEQ))
    grad_rel = {p: rel_l2(full(g), dict(tu.flatten_with_paths(gr))[p])
                for p, g in tu.flatten_with_paths(gs)}
    ref_step = steps.make_train_step(ctx, cfg, opt)
    sh_step = steps.make_train_step(sctx, cfg, opt, mesh)
    losses = []
    for i in range(2):
        ref, rm = ref_step(ref, make_batch(gen, i, "cpu"))
        st, sm = sh_step(st, make_global_batch(gen, i, mesh, tspec))
        losses.append([float(sm["loss"]), float(rm["loss"]),
                       float(sm["grad_norm"]), float(rm["grad_norm"])])
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


def main():
    rank, world, store, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4])
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    res = {}
    try:
        shape = (2, world // 2)
        mesh = mesh_lib.make_mesh(shape, ("data", "model"), "cpu")
        res["mesh"] = list(shape)
        res["train"] = check_train(mesh)
        if world == 2:        # the recurrent and MoE blocks on DTensors
            res["train_families"] = {a: check_train(mesh, a) for a in
                                     FAMILIES}
        res["ops"] = check_ops(mesh)
        res["batch"] = check_batch(mesh)
        if world == 4:
            res["elastic"] = check_elastic(outdir, rank)
    except Exception:                              # reported to the test
        res["error"] = traceback.format_exc()
    finally:
        with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()
    sys.exit(1 if "error" in res else 0)


if __name__ == "__main__":
    main()
