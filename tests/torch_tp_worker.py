"""One rank of the port's tensor-parallel CPU checks (`tests/
test_torch_tensor_parallel.py`): gloo over a file store, a 2 x 2
("data", "model") mesh, the port only (no JAX).

    python tests/torch_tp_worker.py RANK WORLD INIT_FILE DIR

Reads `DIR/inputs.pt` (seeded inputs and state_dicts the test wrote),
runs every case on this rank and writes `DIR/out_<RANK>.pt`: one
tensor-parallel train step of the tiny config and of a flat-eligible one
(the full state and gradients gathered, one process's gradients on the
global batch, this rank's own state, and for the tiny one
the `.npz` `export_params` wrote, read back), the `tp_layout`
logits sharded over both groups, the text features of the cut tower and
the fast_cal predictor's labels under the mesh beside one process's.
"""

import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from lseg_tpu_torch.engine.serve import (  # noqa: E402
    make_data_sharded_logits_fn,
    make_data_sharded_predictor,
)
from lseg_tpu_torch.models.lseg import LSegNet  # noqa: E402
from lseg_tpu_torch.parallel import (  # noqa: E402
    batch_shard,
    create_mesh,
    gather_grads,
    gather_module,
    init_distributed,
)
from lseg_tpu_torch.testing import TINY_TEXT, tiny_vit_config  # noqa: E402
from lseg_tpu_torch.text.cache import encode_labels  # noqa: E402
from lseg_tpu_torch.train.checkpoint import (  # noqa: E402
    export_params,
    import_params,
)
from lseg_tpu_torch.train.optim import make_optimizer  # noqa: E402
from lseg_tpu_torch.train.step import (  # noqa: E402
    TrainState,
    enable_grads,
    make_train_step,
)
from torch_parallel_worker import int8_config  # noqa: E402

N_DATA, N_MODEL = 2, 2


def flat_config(base):
    """`base` (either package's tiny config) at width 256 with four heads
    on 'flashflat': two heads of 64 a rank, so the cut attention stays
    flat-eligible."""
    return dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, embed_dim=256, num_heads=4, attn_impl="flashflat"))


def tp_layout_config(base):
    return dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, tp_layout=True))


def _state(cfg, tree):
    model = LSegNet(cfg, torch.float32, remat=True,
                    param_dtype=torch.float32)
    model.load_state_dict(tree)
    enable_grads(model)
    return TrainState(model, make_optimizer(model, 0.01, 100, batch_size=4))


def train_case(cfg, tree, inp, mesh, export=None):
    state = _state(cfg, tree)
    model = state.model
    batch = {"image": batch_shard(inp["x"], mesh.data),
             "target": batch_shard(inp["tgt"], mesh.data)}
    state, m = make_train_step(-1, 1, mesh)(state, batch, inp["txt"])
    # one process's step on the global batch, for the gradients
    one = _state(cfg, tree)
    make_train_step(-1)(one, {"image": inp["x"], "target": inp["tgt"]},
                        inp["txt"])
    exported = None
    if export is not None:
        export_params(export, model)
        exported = import_params(export)
    return {"loss": float(m["loss"]), "labeled": int(m["labeled"]),
            "exported": exported,
            "gathered": gather_module(model),
            "grads": {k: v.clone() for k, v in gather_grads(model).items()},
            "one_grads": {n: p.grad.clone()
                          for n, p in one.model.named_parameters()
                          if p.grad is not None},
            "local": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "flat": [b.attn.flat for b in model.vit.blocks],
            "heads": [b.attn.num_heads for b in model.vit.blocks]}


def fast_cal_case(inp, mesh):
    cfg = int8_config(tiny_vit_config())
    labels = make_data_sharded_predictor(LSegNet(cfg, torch.bfloat16),
                                         inp["tiny_q"], mesh)(inp["xq"],
                                                              inp["txt"])
    one = LSegNet(cfg, torch.bfloat16)
    one.load_state_dict(inp["tiny_q"])
    one.eval()
    with torch.inference_mode():
        whole = one(inp["xq"], inp["txt"], return_argmax=True)
        shard = one(batch_shard(inp["xq"], mesh.data), inp["txt"],
                    return_argmax=True)
    return {"labels": labels, "one_process": whole, "shard": shard}


def main():
    r, w, init, out_dir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           Path(sys.argv[4]))
    torch.set_num_threads(1)
    init_distributed(f"file://{init}", w, r, backend="gloo")
    mesh = create_mesh(N_DATA, N_MODEL)
    inp = torch.load(out_dir / "inputs.pt", weights_only=False)
    tiny = tiny_vit_config()
    tokens = inp["tokens"]
    res = {
        "coord": mesh.coord,
        "train": {"tiny": train_case(tiny, inp["tiny"], inp, mesh,
                                     out_dir / f"export_{r}.npz"),
                  "flat": train_case(flat_config(tiny), inp["flat"], inp,
                                     mesh)},
        "tp_layout": make_data_sharded_logits_fn(
            LSegNet(tp_layout_config(tiny)), inp["tp"], mesh)(
                inp["x"], inp["txt"]),
        "text": encode_labels(TINY_TEXT, inp["text"],
                              lambda labels: tokens[:len(labels)],
                              inp["labels"], mesh=mesh),
        "fast_cal": fast_cal_case(inp, mesh)}
    torch.save(res, out_dir / f"out_{r}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
