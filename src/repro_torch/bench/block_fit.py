"""Where ``measured.measure_block``'s time goes on the card: its two programs
(the one-layer forward and the gradient of ``loss_fn``) on the reference's
all-zero batch (``measured.block_batch``) and on seeded tokens drawn
uniformly from the one-layer vocabulary, and the embedding lookup's
backward alone on the same tokens, by indexing (``embed[tokens]``, whose
backward is ``index_put_`` with accumulate) and by ``F.embedding`` (the
model's, ``transformer.embed``), each captured as a CUDA graph and its
replays timed by CUDA events (``measured.graphed_program``,
``measured._replay_time``).  Then the lookup's backward alone on the train
path's batches (``train.data.SyntheticDataset``'s Zipf tokens, 2
microbatches of 4 x 1024, the full vocabulary's table in the config's
dtype), both ways, a step's worth (one backward a microbatch).

    cd src && python3 -m repro_torch.bench.block_fit [arch] [seq_len] [dtype]

Defaults: smollm_360m, 1024, bfloat16 (the train path's).  Prints one JSON
line per (batch, mbs), one with the fit (``measured.fit_rate``, the
median ``calibrate_cpu_host`` takes) under each batch, and one for the
train path's lookup.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.profiler import measured
from repro_torch.models import model as model_lib
from repro_torch.train import data as data_lib

# the train path's data (chip_smoke.py's TRAIN_DATA)
TRAIN_DATA = dict(seq_len=1024, global_batch=8, num_microbatches=2)


def _embed_bwd(params, tokens: torch.Tensor, lookup):
    """The gradient of the lookup ``lookup(embed, tokens)`` alone."""
    emb = params["embed"]
    go = torch.ones(tuple(tokens.shape) + (emb.shape[1],), dtype=emb.dtype,
                    device=emb.device)

    def run():
        e = emb.detach().requires_grad_()
        return torch.autograd.grad(lookup(e, tokens), e, go)[0]
    return run


# indexing (its backward is index_put_ with accumulate) and the model's
# F.embedding (embedding_dense_backward)
LOOKUPS = {"index": lambda e, t: e[t],
           "F.embedding": lambda e, t: torch.nn.functional.embedding(t, e)}


def main(argv) -> int:
    arch = argv[0] if argv else "smollm_360m"
    seq_len = int(argv[1]) if len(argv) > 1 else 1024
    dtype = argv[2] if len(argv) > 2 else "bfloat16"
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    one = measured.one_layer(cfg, dtype)
    params = model_lib.init(one, 0, device="cuda")
    fl_tok = 2 * cfg.layer_params()
    rows = {}
    for kind in ("zeros", "uniform"):
        rows[kind] = []
        for mbs in (1, 2, 4):
            batch = measured.block_batch(one, mbs, seq_len, "cuda")
            if kind == "uniform":
                rng = np.random.default_rng(0)
                batch = {k: torch.from_numpy(rng.integers(
                    0, one.vocab_size, v.shape, dtype=np.int32)).cuda()
                    for k, v in batch.items()}
            fwd, grad = measured.block_programs(one, params, batch)
            t_f = measured._replay_time(measured.graphed_program(fwd, params))
            t_fb = measured._replay_time(
                measured.graphed_program(grad, params))
            t_e = {name: measured._replay_time(measured.graphed_program(
                _embed_bwd(params, batch["tokens"], fn), params)) * 1e3
                for name, fn in LOOKUPS.items()}
            fl = fl_tok * mbs * seq_len
            rows[kind].append((mbs, t_f, t_fb))
            print(json.dumps(dict(
                arch=arch, seq_len=seq_len, dtype=dtype, batch=kind, mbs=mbs,
                distinct_tokens=int(batch["tokens"].unique().numel()),
                fwd_ms=t_f * 1e3, fwd_bwd_ms=t_fb * 1e3,
                embed_bwd_ms=t_e,
                fwd_tflops=fl / t_f / 1e12,
                fwd_bwd_tflops=3 * fl / t_fb / 1e12)), flush=True)
    print(json.dumps({f"fit_tflops_{k}": measured.fit_rate(cfg, seq_len, r)
                      / 1e12 for k, r in rows.items()}), flush=True)
    params = model_lib.init(cfg, 0, device="cuda")
    micro = data_lib.SyntheticDataset(cfg, data_lib.DataConfig(
        **TRAIN_DATA)).batch(0)["tokens"]
    step_ms = {name: 0.0 for name in LOOKUPS}
    for toks in micro:
        t = torch.from_numpy(toks).cuda()
        for name, fn in LOOKUPS.items():
            step_ms[name] += measured._replay_time(measured.graphed_program(
                _embed_bwd({"embed": params["embed"]}, t, fn), params)) * 1e3
    counts = np.bincount(micro.reshape(len(micro), -1)[0])
    print(json.dumps(dict(
        train_lookup=dict(arch=arch, **TRAIN_DATA, dtype=cfg.param_dtype,
                          most_repeated_token_count=int(counts.max()),
                          embed_bwd_ms_a_step=step_ms))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
