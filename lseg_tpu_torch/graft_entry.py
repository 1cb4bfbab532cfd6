"""Top-level entry points (torch port of `__graft_entry__.py`).

- `entry()`: (fn, args) of the flagship forward, LSeg ViT-L/16 in bf16 at
  480x480 with a 150-label text matrix (the ADE20K zero-shot serving
  shape), seeded random weights on the card;
- `dryrun_multichip(n)`: n gloo ranks sharing the card (or, when the
  caller asks, on the CPU), over an (n / 2) x 2 ("data", "model") mesh for an even n (n x 1
  otherwise), at tiny shapes. Each rank runs one sharded train step of
  the tiny ViT config (data-parallel over the data group, tensor-parallel
  over the model group), the `tp_layout` eval forward sharded over both
  groups and the data-sharded fast-int8 predictor over all n ranks, each
  held against one process's result computed in the same rank.

The JAX package's `flagship_aot_lower` traces the three flagship-shape
graphs without running them; PyTorch has no trace-only counterpart, and
`chip_smoke.py`'s phase 13 runs the train step, the `tp_layout` forward
and the text tower at the flagship's full width on the card instead.

    python -m lseg_tpu_torch.graft_entry                 # entry() on the card
    python -m lseg_tpu_torch.graft_entry dryrun 4        # 2 x 2, on the card
    python -m lseg_tpu_torch.graft_entry dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# rank-side tolerances of the held-against-one-process checks (fp32; the
# JAX package's `test_sharded_train_step_matches_single_device`)
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
LOGITS_RTOL, LOGITS_ATOL = 1e-4, 1e-5
RANK_TIMEOUT = 300


def entry(device=None):
    """(forward, (model, x, txt)): the flagship LSeg ViT-L/16 bf16 forward
    at 480x480 with a (150, 512) text matrix; `device` the card."""
    from lseg_tpu_torch import get_config
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet

    cfg = get_config("clip_vitl16_384")
    device = torch.device(device if device is not None else "cuda")
    g = torch.Generator(device=device).manual_seed(0)
    model = random_init_(LSegNet(cfg, torch.bfloat16, device), g).eval()
    x = torch.zeros((1, 480, 480, 3), device=device)
    txt = torch.zeros((150, cfg.out_c), device=device)

    @torch.inference_mode()
    def forward(model, x, txt):
        return model(x, txt)

    return forward, (model, x, txt)


def _tiny_int8_config():
    """The fast-serving int8 stack at tiny shape: width 128 with two heads
    (B2 needs head_dim 64 and an even head count), static_cal, a joint
    embedding of 128 (B4 on the card takes E a multiple of 128)."""
    from lseg_tpu_torch import fast_serving
    from lseg_tpu_torch.testing import tiny_vit_config

    base = tiny_vit_config(out_c=128)
    return fast_serving(dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, embed_dim=128, num_heads=2)), quant="static_cal")


def _close(name, got, ref, rtol, atol):
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol,
                               msg=lambda m: f"{name}: {m}")


def _train_check(cfg, mesh, d, n_data, device):
    """One sharded train step against one process's over the global
    batch: the loss and every gathered parameter and statistic."""
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.parallel import gather_module
    from lseg_tpu_torch.train.optim import make_optimizer
    from lseg_tpu_torch.train.step import (
        TrainState,
        enable_grads,
        make_train_step,
    )

    batch = 2 * n_data  # 2 rows a data shard
    g = torch.Generator().manual_seed(1)
    x = torch.randn(batch, 64, 64, 3, generator=g).to(device)
    tgt = torch.randint(0, 5, (batch, 64, 64), generator=g).to(device)
    txt = torch.randn(5, cfg.out_c, generator=g).to(device)
    init = random_init_(LSegNet(cfg, device=device),
                        torch.Generator(device=device).manual_seed(0)
                        ).state_dict()

    def state():
        model = LSegNet(cfg, torch.float32, device, remat=True,
                        param_dtype=torch.float32)
        model.load_state_dict(init)
        enable_grads(model)
        return TrainState(model, make_optimizer(model, 0.004, 100,
                                                batch_size=batch))

    one, m_one = make_train_step(-1)(state(), {"image": x, "target": tgt},
                                     txt)
    rows = slice(2 * d, 2 * d + 2)
    tp, m_tp = make_train_step(-1, 1, mesh)(
        state(), {"image": x[rows], "target": tgt[rows]}, txt)
    _close("loss", m_tp["loss"], m_one["loss"], LOSS_RTOL, 0.0)
    full, ref = gather_module(tp.model), one.model.state_dict()
    if list(full) != list(ref):
        raise AssertionError("the gathered state's names differ")
    for name, t in full.items():
        _close(name, t, ref[name], PARAM_RTOL, PARAM_ATOL)
    return float(m_tp["loss"]), ref, x, txt


def _tp_layout_check(cfg, state, mesh, x, txt):
    """The `tp_layout` eval forward, its rows over the data group and its
    heads over the model group, against one process's flat-layout
    forward on the same weights."""
    from lseg_tpu_torch.engine.serve import (
        make_data_sharded_logits_fn,
        make_logits_fn,
    )
    from lseg_tpu_torch.models.lseg import LSegNet

    cfg_tp = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, tp_layout=True))
    device = x.device
    logits = make_data_sharded_logits_fn(LSegNet(cfg_tp, device=device),
                                         state, mesh)(x, txt)
    ref = make_logits_fn(LSegNet(cfg, device=device), state)(x, txt)
    _close("tp_layout logits", logits, ref, LOGITS_RTOL, LOGITS_ATOL)
    return tuple(logits.shape)


def _fast_int8_check(r, n, device):
    """The data-sharded fast-int8 predictor over all n ranks (a data-only
    mesh): each rank's rows of the gathered map equal one process's call
    on those rows, bit for bit."""
    from lseg_tpu_torch.engine.serve import make_data_sharded_predictor
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.quant import calibrate_act_scales, quantize_tree
    from lseg_tpu_torch.parallel import create_mesh

    cfg = _tiny_int8_config()
    cfg0 = dataclasses.replace(cfg, vit=dataclasses.replace(
        cfg.vit, attn_impl="xla", quant_int8=False, patch_fused=False),
        decoder_quant=False)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(n, 64, 64, 3, generator=g).to(device)
    txt = torch.randn(4, cfg.out_c, generator=g).to(device)
    ref = random_init_(LSegNet(cfg0, device=device),
                       torch.Generator(device=device).manual_seed(3))
    model = LSegNet(cfg, torch.bfloat16, device)
    model.load_state_dict(quantize_tree(ref.state_dict(), decoder=True,
                                        act_scale=True))
    calibrate_act_scales(model, x, txt)
    labels = make_data_sharded_predictor(model, None, create_mesh())(x, txt)
    with torch.inference_mode():
        local = model(x[r:r + 1], txt, return_argmax=True)
    if labels.shape != (n, 64, 64) or not torch.equal(labels[r:r + 1],
                                                       local):
        raise AssertionError(f"rank {r}: the gathered fast-int8 labels "
                             f"differ from one process's on its row")
    return n


def _rank(r: int, n: int, store: str, out_dir: str, device: str) -> int:
    """One rank of `dryrun_multichip`."""
    from lseg_tpu_torch.parallel import create_mesh, init_distributed
    from lseg_tpu_torch.testing import tiny_vit_config

    torch.set_num_threads(1)
    device = torch.device("cuda", 0) if device == "cuda" else \
        torch.device(device)
    # fp32 checks: TF32 products would round the two sides apart
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_distributed(f"file://{store}", n, r, backend="gloo")
    n_model = 2 if n % 2 == 0 else 1
    n_data = n // n_model
    mesh = create_mesh(n_data, n_model)
    d = r // n_model
    cfg = tiny_vit_config()
    loss, state, x, txt = _train_check(cfg, mesh, d, n_data, device)
    shape = _tp_layout_check(cfg, state, mesh, x, txt)
    fast = _fast_int8_check(r, n, device)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump({"mesh": [n_data, n_model], "loss": loss,
                   "eval_tp_logits": shape, "fast_int8_batch": fast}, f)
    torch.distributed.destroy_process_group()
    return 0


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Start `n_devices` gloo ranks of this module (each one process; all
    on the card, or on the CPU with `device='cpu'`), wait for all, and
    return rank 0's summary; raises if CUDA is missing and the CPU was
    not asked for, or if a rank fails or outlives RANK_TIMEOUT seconds."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device (pass "
                           "device='cpu' to run the ranks on the CPU)")
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "lseg_tpu_torch.graft_entry", "rank",
             str(r), str(n_devices), os.path.join(tmp, "store"), tmp,
             "--device", device],
            env=env, cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for r in range(n_devices)]
        try:
            outs = [p.communicate(timeout=RANK_TIMEOUT)[0].decode()
                    for p in procs]
        except subprocess.TimeoutExpired:
            outs = None
        finally:
            for p in procs:
                p.kill()
                p.wait()
        if outs is None:
            raise RuntimeError(f"dryrun_multichip: a rank ran past "
                               f"{RANK_TIMEOUT} s")
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"dryrun_multichip: rank {r} exited "
                                   f"{p.returncode}:\n{out[-4000:]}")
        with open(os.path.join(tmp, "rank0.json")) as f:
            summary = json.load(f)
    n_data, n_model = summary["mesh"]
    print(f"dryrun_multichip ok: mesh={{'data': {n_data}, 'model': "
          f"{n_model}}} loss={summary['loss']:.4f} "
          f"eval_tp_logits={tuple(summary['eval_tp_logits'])} "
          f"fast_int8_data_sharded=ok(batch={summary['fast_int8_batch']}) "
          f"device={device} {time.perf_counter() - t0:.1f} s")
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m lseg_tpu_torch.graft_entry",
        description="the flagship forward on the card (no arguments), or "
                    "'dryrun N': N gloo ranks over an (N/2) x 2 mesh at "
                    "tiny shapes, each check held against one process")
    p.add_argument("mode", nargs="?", default="entry",
                   choices=("entry", "dryrun", "rank"))
    p.add_argument("args", nargs="*", help="dryrun: N (default 8)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                   help="where the dryrun's ranks run (default cuda)")
    a = p.parse_args(argv)
    if a.mode == "rank":
        return _rank(int(a.args[0]), int(a.args[1]), a.args[2], a.args[3],
                     a.device)
    if a.mode == "dryrun":
        if a.device == "cuda" and not torch.cuda.is_available():
            print("dryrun: no CUDA device (--device cpu runs the ranks on "
                  "the CPU)", file=sys.stderr)
            return 1
        dryrun_multichip(int(a.args[0]) if a.args else 8, a.device)
        return 0
    if not torch.cuda.is_available():
        print("entry: no CUDA device", file=sys.stderr)
        return 1
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
