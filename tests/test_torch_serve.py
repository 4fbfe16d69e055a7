"""``repro_torch`` serving vs ``repro`` serving on the same weights and requests.

Greedy token sequences must be equal (fp32 logits agree to ~1e-6, far
below any argmax margin these random weights give), and so must the
``decode_steps`` / ``decode_row_steps`` counters of the compaction rule.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve.serve_step import BatchedServer as JServer
from repro.serve.serve_step import Request as JRequest
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tm
from repro_torch.serve import kv_cache as tkv
from repro_torch.serve.serve_step import BatchedServer as TServer
from repro_torch.serve.serve_step import Request as TRequest
from test_torch_model import both_params, configs


def _requests(cls, prompts, max_new):
    return [cls(rid=i, prompt=p, max_new_tokens=m)
            for i, (p, m) in enumerate(zip(prompts, max_new))]


def _serve_both(arch, prompts, max_new, *, seed, max_len, batch_size):
    jcfg, tcfg = configs(arch)
    jp, tp = both_params(jcfg, tcfg, seed)
    jreqs = _requests(JRequest, prompts, max_new)
    treqs = _requests(TRequest, prompts, max_new)
    js = JServer(jcfg, jp, max_len=max_len, batch_size=batch_size)
    ts = TServer(tcfg, tp, max_len=max_len, batch_size=batch_size)
    js.run(jreqs)
    ts.run(treqs)
    return (js, jreqs), (ts, treqs), (tcfg, tp)


def test_batched_server_matches_reference_and_teacher_forcing():
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, 8).astype(np.int32)
    (js, jr), (ts, tr), (cfg, params) = _serve_both(
        "smollm_360m", [prompt], [6], seed=0, max_len=32, batch_size=4)
    assert tr[0].done and tr[0].output == jr[0].output
    assert len(tr[0].output) == 6
    # greedy decode via repeated full forward in the port
    toks, want = list(prompt), []
    for _ in range(6):
        logits = tm.forward(cfg, params, {"tokens": torch.tensor([toks])})
        want.append(int(torch.argmax(logits[0, -1])))
        toks.append(want[-1])
    assert tr[0].output == want


def test_batched_server_mixed_lengths_matches_reference():
    """qwen (qkv bias), left-padded prompts of different lengths."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, 4 + 3 * i).astype(np.int32)
               for i in range(3)]
    (js, jr), (ts, tr), _ = _serve_both(
        "qwen1_5_0_5b", prompts, [3, 4, 5], seed=1, max_len=64,
        batch_size=4)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert [len(r.output) for r in tr] == [3, 4, 5]
    assert all(r.done for r in tr)


def test_batched_server_compacts_dead_rows_like_reference():
    """One 24-token straggler + three 3-token shorts (test_serve.py:64-83):
    2x4 + 21x1 = 29 row steps over 23 decode steps, in both packages."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 8).astype(np.int32) for _ in range(4)]
    (js, jr), (ts, tr), _ = _serve_both(
        "smollm_360m", prompts, [24, 3, 3, 3], seed=2, max_len=64,
        batch_size=4)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert (ts.decode_steps, ts.decode_row_steps) == (23, 29)
    assert (ts.decode_steps, ts.decode_row_steps) \
        == (js.decode_steps, js.decode_row_steps)


def test_batched_server_several_batches_and_the_kernel_path():
    """More requests than the batch; the kernel path (attention kernel +
    fused norm, plain versions on the CPU) gives the same tokens."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, int(n)).astype(np.int32)
               for n in rng.integers(5, 12, 5)]
    (js, jr), (ts, tr), (cfg, params) = _serve_both(
        "smollm_360m", prompts, [4, 2, 5, 3, 4], seed=3, max_len=32,
        batch_size=2)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert (ts.decode_steps, ts.decode_row_steps) \
        == (js.decode_steps, js.decode_row_steps)
    kcfg = dataclasses.replace(cfg, attn_impl="kernel")
    kreqs = _requests(TRequest, prompts, [4, 2, 5, 3, 4])
    TServer(kcfg, params, max_len=32, batch_size=2).run(kreqs)
    assert [r.output for r in kreqs] == [r.output for r in jr]


def test_grow_cache_and_cache_bytes():
    _, cfg = configs("smollm_360m")
    params = tm.init(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 5)))
    _, cache = tm.forward(cfg, params, {"tokens": toks}, return_cache=True)
    full = tm.init_cache(cfg, 2, 16, device="cpu")
    out = tkv.grow_cache(cache, full)
    assert out["len"] == 5 and out["k"].shape == (2, 2, 16, 2, 64)
    assert torch.equal(out["k"][:, :, :5], cache["k"])
    assert torch.all(out["k"][:, :, 5:] == 0)
    same = tkv.grow_cache(cache, {k: v for k, v in cache.items()})
    assert torch.equal(same["v"], cache["v"])
    assert tkv.cache_bytes(out) == 2 * 2 * 2 * 16 * 2 * 64 * 4


def test_launch_serve_runs_on_cpu(capsys):
    tlaunch.main(["--arch", "smollm_360m", "--reduced", "--device", "cpu",
                  "--requests", "3", "--prompt-len", "6", "--max-new", "4",
                  "--batch-size", "2"])
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "tok/s" in out
    assert "[serve:static:cpu]" in out
    tlaunch.main(["--arch", "smollm_360m", "--reduced", "--device", "cpu",
                  "--requests", "3", "--prompt-len", "6", "--max-new", "4",
                  "--batch-size", "2", "--continuous"])
    out = capsys.readouterr().out
    assert "[serve:continuous:cpu] 3 requests, 12 tokens" in out
    with pytest.raises(SystemExit):
        tlaunch.main(["--arch", "smollm_360m", "--reduced", "--device",
                      "cpu", "--no-such-flag"])


def test_launch_serve_requests_match_reference():
    from repro.launch.serve import make_requests as jmake
    cfg = configs("qwen1_5_0_5b")[1]
    a = tlaunch.make_requests(cfg, 3, 7, 2, seed=5)
    b = jmake(cfg, 3, 7, 2, seed=5)
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
