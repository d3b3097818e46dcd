"""The chunked SSD's yardstick for the card checks (``chip_smoke.py`` and
``test_torch_cuda.py``): the naive recurrence in fp64, and how closely an
fp32 evaluation of the chunked form can agree with it."""

import torch


def ssd_fp64(x, dt, a_log, b, c, *, d_skip=None, initial_state=None):
    """One step per token in fp64: ``S = exp(dt a) S + dt B x^T``, ``y = C S
    + d_skip x``, head h on group h // (H // G). Returns y (B, T, H, P) and
    the final state (B, H, N, P), both fp64; ``initial_state`` (B, H, N, P)
    or None (zeros)."""
    f64 = torch.float64
    bsz, t, h, p = x.shape
    n, hpg = b.shape[3], h // b.shape[2]
    dt = dt.to(f64)
    decay = torch.exp(dt * -torch.exp(a_log.to(f64)))
    bf = b.to(f64).repeat_interleave(hpg, dim=2)               # (B, T, H, N)
    cf = c.to(f64).repeat_interleave(hpg, dim=2)
    xf = x.to(f64)
    state = torch.zeros((bsz, h, n, p), dtype=f64, device=x.device) \
        if initial_state is None else initial_state.to(f64)
    ys = []
    for i in range(t):
        state = state * decay[:, i, :, None, None] + \
            bf[:, i, :, :, None] * (dt[:, i, :, None] * xf[:, i])[:, :, None]
        ys.append(torch.einsum("bhnp,bhn->bhp", state, cf[:, i]))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip.to(f64)[None, None, :, None] * xf
    return y, state


def fp32_tolerance(dt, a_log, chunk: int) -> float:
    """How closely an fp32 evaluation of the chunked SSD can agree with the
    exact result, relative to the output's largest magnitude.

    ``exp(seg_i - seg_j)`` turns an absolute rounding error in the
    per-chunk cumulative sum ``seg = cumsum(dt * a)`` into the same
    relative error of every decay term, and one fp32 add rounds by up to
    half an ulp of ``|seg|``; the terms that carry the result sit within a
    few steps of each other (strong decay) or span a chunk (weak decay, on
    smaller sums). 16 fp32 epsilons of the largest per-chunk ``|seg|``
    bound both, with a floor of 1e-5 for the other sums' order."""
    bsz, t, h = dt.shape
    q = min(chunk, t)
    pad = (-t) % q
    a = -torch.exp(a_log.to(torch.float64))
    dta = torch.nn.functional.pad(dt.to(torch.float64) * a, (0, 0, 0, pad))
    seg = torch.cumsum(dta.reshape(bsz, -1, q, h), dim=2)
    eps = torch.finfo(torch.float32).eps
    return max(1e-5, 16 * eps * float(seg.abs().max()))
