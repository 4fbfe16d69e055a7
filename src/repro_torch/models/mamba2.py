"""Mamba-2 (SSD, state-space duality) in PyTorch (counterpart of
``repro/models/mamba2.py``).

Chunked SSD algorithm (arXiv:2405.21060 §6): the sequence is split into
chunks of length Q; within-chunk terms use the quadratic "attention-like"
form, cross-chunk terms flow through a recurrent state carried over chunks
(a Python loop where the reference scans).

Two routes run the SSD, named by ``mamba_block``'s ``impl`` and picked in
the open by ``pick_ssd_impl``:

* ``"kernel"``: ``kops.ssd_scan``, the CUDA kernel on the card (its plain
  version on the CPU).  It starts from a zero state and has no backward,
  so it serves prefills without a gradient;
* ``"chunked"``: ``ssd_chunked`` below, plain PyTorch that autograd
  differentiates, and which takes a carried state (decode).

``ssd_chunked`` takes the exponential of the within-chunk decay on the
lower triangle only (the kernel does the same): the reference takes it
over the whole chunk square and discards the upper half, whose entries
overflow once a chunk's |sum dt*a| passes ~88, so its gradient w.r.t. dt
turns to inf/nan there; the forward values are the same.

Decode carries a constant-size state (B, H, P, N), no KV cache.
Simplifications vs. the published model (as in the reference):
ngroups=1 for B/C, no bias terms, RMSNorm gate, depthwise conv k=4.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.device import is_cuda_like, torch_dtype
from repro_torch.dist.sharding import Decl
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

CONV_K = 4
SSD_IMPLS = ("kernel", "chunked")


# --- declarations ----------------------------------------------------------------

def ssm_layer_decls(cfg: ModelConfig, stacked: bool = True,
                    n_layers: Optional[int] = None) -> Dict[str, Decl]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_nheads
    nl = n_layers if n_layers is not None else cfg.n_layers
    pre = (nl,) if stacked else ()
    pax = ("layers",) if stacked else ()

    def decl(shape, axes, **kw):
        return Decl(pre + tuple(shape), pax + tuple(axes), **kw)

    conv_dim = di + 2 * n
    return {
        "ln": decl((d,), ("embed",), init="ones"),
        # in_proj -> [z(di), x(di), B(n), C(n), dt(h)]
        "w_in": decl((d, 2 * di + 2 * n + h), ("embed", "ssm_inner"),
                     scale_dim=-2),
        "conv_w": decl((CONV_K, conv_dim), (None, "ssm_inner"), init="normal",
                       scale_dim=0),
        "conv_b": decl((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": decl((h,), (None,), init="a_log"),
        "dt_bias": decl((h,), (None,), init="dt_bias"),
        "d_skip": decl((h,), (None,), init="ones"),
        "gate_ln": decl((di,), ("ssm_inner",), init="ones"),
        "w_out": decl((di, d), ("ssm_inner", "embed"), scale_dim=-2),
    }


def decls(cfg: ModelConfig) -> Dict:
    d = {
        "embed": Decl((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                      init="embed"),
        "ln_f": Decl((cfg.d_model,), ("embed",), init="ones"),
        "layers": ssm_layer_decls(cfg),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = Decl((cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                            scale_dim=-2)
    return d


def state_decls(cfg: ModelConfig, batch: int, max_len: int = 0
                ) -> Dict[str, Decl]:
    h, hp, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * n
    return {
        "ssm": Decl((cfg.n_layers, batch, h, hp, n),
                    ("layers", None, "ssm_inner", None, None), init="zeros"),
        "conv": Decl((cfg.n_layers, batch, CONV_K - 1, conv_dim),
                     ("layers", None, None, "ssm_inner"), init="zeros"),
        "len": Decl((), (), init="zeros"),
    }


# --- SSD core ----------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, differentiable.

    x:  (B, S, H, P)   per-head inputs
    dt: (B, S, H)      positive step sizes (softplus applied by caller)
    a:  (H,)           negative decay rates (A = -exp(a_log))
    b:  (B, S, N)      input projections  (ngroups=1, shared across heads)
    c:  (B, S, N)      output projections
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) fp32).
    """
    bs, s, h, p = x.shape
    n = b.shape[-1]
    s_orig = s
    if s % chunk != 0:
        # pad with dt=0 steps: decay=exp(0)=1 and update=0, so padding is
        # state-neutral and the padded outputs are simply discarded.
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk

    xr = x.reshape(bs, nc, chunk, h, p).float()
    dtr = dt.reshape(bs, nc, chunk, h).float()
    br = b.reshape(bs, nc, chunk, n).float()
    cr = c.reshape(bs, nc, chunk, n).float()

    # log-decay within chunk: cum[i] = sum_{j<=i} dt_j * a
    cum = torch.cumsum(dtr * a.float(), dim=2)              # (B,nc,Q,H)
    # within-chunk "attention" L[i,j] = exp(cum_i - cum_j) for i>=j; the
    # exponent is zeroed above the diagonal before exp (see module doc)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B,nc,Q,Q,H)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    ldec = torch.where(mask, torch.exp(torch.where(mask, li, 0.0)), 0.0)
    scores = cr @ br.transpose(-1, -2)                      # (B,nc,Q,Q)
    w = scores[..., None] * ldec * dtr[:, :, None, :, :]    # (B,nc,i,j,H)
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w, xr)

    # chunk-local end states: sum_j exp(cum_last - cum_j) dt_j x_j b_j^T
    dec_end = torch.exp(cum[:, :, -1:, :] - cum) * dtr      # (B,nc,Q,H)
    states = torch.einsum("bcjhp,bcjn->bchpn", xr * dec_end[..., None],
                          br)                               # (B,nc,H,P,N)
    chunk_dec = torch.exp(cum[:, :, -1, :])                 # (B,nc,H)

    # recurrence over chunks: running state BEFORE each chunk
    st = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    before = []
    for ci in range(nc):
        before.append(st)
        st = chunk_dec[:, ci, :, None, None] * st + states[:, ci]
    st_before = torch.stack(before, dim=1)                  # (B,nc,H,P,N)

    # cross-chunk output: C_i · (exp(cum_i) * state_before_chunk)
    y_off = torch.einsum("bcin,bchpn->bcihp", cr, st_before) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(bs, s, h, p)[:, :s_orig]
    return y.to(x.dtype), st


def ssd_ref_sequential(x, dt, a, b, c, init_state=None):
    """O(S) sequential oracle (the tests hold ``ssd_chunked`` to it)."""
    bs, s, h, p = x.shape
    n = b.shape[-1]
    st = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    ys = []
    for t in range(s):
        dtt = dt[:, t].float()
        dec = torch.exp(dtt * a)                                # (B,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", dtt, x[:, t].float(),
                           b[:, t].float())
        st = dec[..., None, None] * st + upd
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t].float(), st))
    return torch.stack(ys, dim=1).to(x.dtype), st


def pick_ssd_impl(device: Union[str, torch.device], *, prefill: bool,
                  grad: bool) -> str:
    """The SSD's route: the kernel on a CUDA device for a prefill (a call
    from a zero state) that takes no gradient; else ``"chunked"`` (a
    decode step from a carried state, which the kernel does not take; any
    call under autograd, the kernel having no backward; the CPU)."""
    if is_cuda_like(device) and prefill and not grad:
        return "kernel"
    return "chunked"


# --- layer forward -------------------------------------------------------------------

def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, k=CONV_K. x: (B,S,C); w: (K,C).

    Returns (y, new_state) where state is the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i] for i in range(k)) + bias
    return F.silu(y), xp[:, -(k - 1):]


def mix_in(xn: torch.Tensor, w_in: torch.Tensor, conv_w: torch.Tensor,
           conv_b: torch.Tensor, di: int, n: int, h: int,
           conv_state: Optional[torch.Tensor] = None):
    """The in-projection of the normed ``xn``, split ``[z | x | B | C |
    dt]``, and the causal conv over ``[x | B | C]``: (z, x, B, C, dt before
    its softplus, the conv's new state).  ``di`` and ``h`` are the widths
    of x and dt these weights hold: the whole layer's, or a mesh
    position's heads (``dist/spmd_ssm.py``); B and C are always whole."""
    proj = xn @ w_in
    z, xin, bb, cc, dt = torch.split(proj, [di, di, n, n, h], dim=-1)
    conv_in = torch.cat([xin, bb, cc], dim=-1)
    conv_out, new_conv = _conv1d_causal(conv_in, conv_w, conv_b, conv_state)
    xin, bb, cc = torch.split(conv_out, [di, n, n], dim=-1)
    return z, xin, bb, cc, dt, new_conv


def ssd_skip(cfg: ModelConfig, p, xin: torch.Tensor, dt: torch.Tensor,
             bb: torch.Tensor, cc: torch.Tensor, impl: str,
             ssm_state: Optional[torch.Tensor] = None):
    """The SSD with its skip term over the heads of ``xin`` (B, S, h*P):
    ``p``'s ``dt_bias``, ``a_log`` and ``d_skip`` hold those h heads.
    Returns (y (B, S, h*P), final state (B, h, P, N) fp32)."""
    bs, s, di = xin.shape
    h = dt.shape[-1]
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    xh = xin.reshape(bs, s, h, cfg.ssm_headdim)
    chunk = min(cfg.ssm_chunk, s)
    if impl == "kernel":
        # the split's views have a stride along the last dim; the kernel
        # takes contiguous tensors
        y, st_fin = kops.ssd_scan(xh.contiguous(), dt.contiguous(), a,
                                  bb.contiguous(), cc.contiguous(),
                                  chunk=chunk)
    else:
        y, st_fin = ssd_chunked(xh, dt, a, bb, cc, chunk, ssm_state)
    y = y + xh * p["d_skip"][None, None, :, None].to(y.dtype)
    return y.reshape(bs, s, di), st_fin


def mamba_block(cfg: ModelConfig, p, x: torch.Tensor, *,
                state: Optional[Dict] = None, return_state: bool = False,
                impl: str = "chunked"):
    """One mamba2 layer. x: (B,S,D). ``state``: {'ssm','conv'} to continue
    from (decode); ``impl`` the SSD's route (``SSD_IMPLS``): the kernel
    takes no state, so ``"kernel"`` with one raises."""
    if impl not in SSD_IMPLS:
        raise ValueError(f"mamba_block: unknown SSD impl {impl!r}")
    if impl == "kernel" and state is not None:
        raise ValueError("mamba_block: the SSD kernel starts from a zero "
                         "state; a carried state takes impl='chunked'")
    res = x
    xn = L.rms_norm(x, p["ln"], cfg.norm_eps)
    z, xin, bb, cc, dt, new_conv = mix_in(
        xn, p["w_in"], p["conv_w"], p["conv_b"], cfg.d_inner, cfg.ssm_state,
        cfg.ssm_nheads, None if state is None else state["conv"])
    y, st_fin = ssd_skip(cfg, p, xin, dt, bb, cc, impl,
                         None if state is None else state["ssm"])
    y = L.rms_norm(y * F.silu(z), p["gate_ln"], cfg.norm_eps)
    out = res + (y @ p["w_out"]).to(x.dtype)
    if return_state:
        return out, {"ssm": st_fin, "conv": new_conv}
    return out, None


def mamba_decode_block(cfg: ModelConfig, p, x: torch.Tensor, state: Dict):
    """Single-token recurrent update. x: (B,1,D)."""
    return mamba_block(cfg, p, x, state=state, return_state=True)


# --- full model ------------------------------------------------------------------------

def run_layers(cfg: ModelConfig, layers, x: torch.Tensor, *, impl: str,
               grad: bool, return_state: bool):
    """The stacked mamba layers ``layers`` over x, each under
    ``cfg.remat`` when a gradient will be taken.  Returns (x, per-layer
    ssm states, per-layer conv states) (the lists empty without
    ``return_state``)."""
    def body(x, lp):
        out, st = mamba_block(cfg, lp, x, return_state=return_state,
                              impl=impl)
        return (out, st["ssm"], st["conv"]) if return_state else (out,)

    step = transformer._remat(body, cfg.remat) if grad else body
    stacked = {name: w.unbind(0) for name, w in layers.items()}
    ssms, convs = [], []
    for i in range(len(stacked["ln"])):
        x, *st = step(x, {name: w[i] for name, w in stacked.items()})
        if return_state:
            ssms.append(st[0])
            convs.append(st[1])
    return x, ssms, convs


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            return_cache: bool = False, attn_impl: Optional[str] = None,
            ssd_impl: Optional[str] = None):
    """Logits (B,S,V) fp32 and, with ``return_cache``, the decode state
    (``ssm`` fp32, ``conv`` in ``cfg.dtype``, ``len`` an int).
    ``attn_impl`` is taken for the shared signature and unused;
    ``ssd_impl`` None picks the route (``pick_ssd_impl``)."""
    x = transformer.embed(cfg, params, batch["tokens"])
    grad = transformer._needs_grad(params)
    impl = ssd_impl or pick_ssd_impl(x.device, prefill=True, grad=grad)
    x, ssms, convs = run_layers(cfg, params["layers"], x, impl=impl,
                                grad=grad, return_state=return_cache)
    logits = transformer._head(cfg, params, x)
    if return_cache:
        return logits, {"ssm": torch.stack(ssms), "conv": torch.stack(convs),
                        "len": batch["tokens"].shape[1]}
    return logits


def decode_layer(cfg: ModelConfig, params, i: int, x: torch.Tensor,
                 ssm: torch.Tensor, conv: torch.Tensor, new_ssm: list):
    """Layer ``i``'s decode step on x against ``ssm[i]`` and ``conv[i]``:
    ``conv[i]`` is written in place; the new fp32 SSM state in place into
    an fp32 ``ssm`` (the servers' static state), else appended to
    ``new_ssm`` (a cache from ``init_cache`` holds it in ``cfg.dtype``,
    and the reference's decode returns its state in fp32)."""
    x, st = mamba_decode_block(cfg, transformer._layer(params, i), x,
                               {"ssm": ssm[i], "conv": conv[i]})
    conv[i].copy_(st["conv"])
    if ssm.dtype == torch.float32:
        ssm[i].copy_(st["ssm"])
    else:
        new_ssm.append(st["ssm"])
    return x


def decode(cfg: ModelConfig, params, cache, tokens: torch.Tensor):
    """One decode step. tokens: (B, 1). Returns (logits, cache): ``conv``
    written in place, ``ssm`` as ``decode_layer`` says, ``len + 1``."""
    x = transformer.embed(cfg, params, tokens)
    ssm, conv, new_ssm = cache["ssm"], cache["conv"], []
    for i in range(cfg.n_layers):
        x = decode_layer(cfg, params, i, x, ssm, conv, new_ssm)
    return transformer._head(cfg, params, x), {
        "ssm": torch.stack(new_ssm) if new_ssm else ssm, "conv": conv,
        "len": cache["len"] + 1}


def round_state(cfg: ModelConfig, cache: Dict) -> Dict:
    """A prefill's cache with its fp32 SSM state rounded to ``cfg.dtype``
    (kept in that dtype): the reference's ``grow_cache`` casts the state
    into its ``cfg.dtype`` buffer once, at the hand-off to decode."""
    out = dict(cache)
    out["ssm"] = cache["ssm"].to(torch_dtype(cfg.dtype))
    return out
