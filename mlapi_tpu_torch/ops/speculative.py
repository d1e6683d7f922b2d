"""Speculative decoding: a small DRAFT model proposes k tokens, the
TARGET verifies them all in ONE block forward.

Counterpart of ``mlapi_tpu/ops/speculative.py`` without its single-
program ``_fused`` variants. A round is the draft's k single-token
steps (``decode_step``, through flash-decode under
``decode_attn_impl="flash"``) and ONE target ``extend_core`` block of
``k + 1`` tokens (flash-extend, contiguous or paged). Rejected draft
slots keep stale K/V, masked by ``idx <= pos`` until the next round
overwrites them, so rollback moves no bytes. The JAX package runs a
propose phase as one ``lax.scan`` program; here it is k launches of the
draft's step, and the factories are plain functions on tensors that
write the caches IN PLACE.

Per round the host READS one packed tensor, ``[B, k + 2]``: the
round's emitted tokens (``[:m]`` accepted proposals, ``[m]`` the final
token, the rest filler) and then ``m``. Proposals and the draft's
probabilities stay on the device from propose to verify. What the
round needs from the host (pending tokens, positions, and for sampled
rows its uniforms) is uploaded once at its start.

Two schemes share the round algebra:

- greedy (:func:`speculative_generate`, ``_batched``): the emitted
  stream equals plain target greedy decoding token for token (accepted
  drafts ARE the target's argmax; the round's last token is the
  target's own argmax after them);
- sampled (:func:`speculative_sample`, ``_batched``): the acceptance-
  rejection rule of Leviathan et al. / Chen et al. (accept draft token x
  when ``u * q(x) < p(x)``; at the first rejection draw from
  ``norm(max(p - q, 0))``), distributed exactly as plain target sampling
  under the same temperature / top-k / top-p warp, but not the same
  bytes as the plain path for a seed: the draws come from this module's
  own generators.

Randomness: every draw is a uniform from a CPU ``torch.Generator``
seeded by ``models/gpt._stream_seed(seed, (tag << 32) | index)``, one
namespace per role (:data:`_DRAFT_TAG` the draft's proposal draws,
:data:`_ACC_TAG` the acceptance uniforms, :data:`_RES_TAG` the residual
or bonus draw), ``index`` the emitted-token position the draw decides.
The plain decode draw at token ``i`` is seeded by ``_stream_seed(seed,
i)``: the two pre-mix words differ by a multiple of 2**32, and the only
inputs ``_stream_seed`` maps to one seed differ by 2**63 ± 2**32 ± 2, so
no role's seed equals the plain draw's at the same token index. A
categorical draw is the inverse CDF at its uniform
(:func:`_categorical`), on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

# Role namespaces, the JAX package's fold_in tags.
_DRAFT_TAG = 1 << 30
_ACC_TAG = (1 << 30) + 1
_RES_TAG = (1 << 30) + 2


@dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0
    emitted: int = 0
    fallback_steps: int = 0  # budget or window exhausted: a plain step
    per_round: list = field(default_factory=list)

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0

    @property
    def tokens_per_round(self) -> float:
        return self.emitted / self.rounds if self.rounds else 0.0


# -- randomness ------------------------------------------------------------

def _role_seed(seed: int, tag: int, index: int) -> int:
    """The generator seed of role ``tag``'s draw at token ``index``."""
    from mlapi_tpu_torch.models.gpt import _stream_seed

    return _stream_seed(seed, (int(tag) << 32) | int(index))


def _uniform(seed: int, tag: int, index: int) -> float:
    gen = torch.Generator().manual_seed(_role_seed(seed, tag, index))
    return float(torch.rand((), generator=gen))


def _round_uniforms(seeds, step0, k: int) -> np.ndarray:
    """Every uniform a sampled round of each row uses, ``[B, 3k + 2]``
    float32: the draft's draws at indices ``step0 + j`` (``j < k + 1``;
    the batched propose's trailing step reads the last), the acceptance
    uniforms (``j < k``), then the residual / bonus draws (``j < k +
    1``): :func:`_split_uniforms` cuts them apart on the device."""
    out = np.empty((len(seeds), 3 * k + 2), np.float32)
    for b, (seed, s0) in enumerate(zip(seeds, step0)):
        col = 0
        for tag, n in ((_DRAFT_TAG, k + 1), (_ACC_TAG, k), (_RES_TAG, k + 1)):
            for j in range(n):
                out[b, col] = _uniform(int(seed), tag, int(s0) + j)
                col += 1
    return out


def _split_uniforms(u, k: int):
    """``(u_draft [B, k+1], u_acc [B, k], u_res [B, k+1])``."""
    return u[:, :k + 1], u[:, k + 1:2 * k + 1], u[:, 2 * k + 1:]


def _categorical(probs, u):
    """Row ``b``'s draw from ``probs [B, V]`` at uniform ``u[b]``: the
    first index whose cumulative probability exceeds ``u * total``,
    never an index of probability 0."""
    cum = torch.cumsum(probs, dim=-1)
    x = u.to(cum.dtype)[:, None] * cum[:, -1:]
    idx = (cum <= x).sum(dim=-1)
    v = probs.shape[-1]
    last = v - 1 - torch.argmax(
        torch.flip(probs > 0, dims=(-1,)).to(torch.int32), dim=-1)
    return torch.minimum(idx, last)


# -- warps, acceptance -----------------------------------------------------

def _warp_args(temps, top_k, top_p, device):
    """Host warp vectors → the device ``(temps, top_k, top_p, need)``
    :func:`_warped_probs` takes; ``need`` (any filter on) is decided on
    the host, as ``_pick_token`` decides it."""
    temps = np.asarray(temps, np.float32)
    top_k = np.asarray(top_k, np.int64)
    top_p = np.asarray(top_p, np.float32)
    need = np.any(top_k > 0) or np.any((top_p > 0.0) & (top_p < 1.0))
    return (torch.as_tensor(temps, device=device),
            torch.as_tensor(top_k, device=device),
            torch.as_tensor(top_p, device=device), bool(need))


def _warped_probs(logits, temps, top_k, top_p, need: bool = True):
    """The distribution ``models/gpt._pick_token`` samples a ``temps >
    0`` row from: softmax of the top-k / top-p filtered, temperature-
    scaled logits ``[N, V]`` (warp tensors ``[N]`` on the logits'
    device). Shares the model zoo's own filter, so draft == target gives
    ``p / q == 1`` exactly. The filter is the identity where it is off;
    ``need=False`` skips its sorts."""
    from mlapi_tpu_torch.models.gpt import _filter_top_k_top_p

    safe_t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
    scaled = logits / safe_t[:, None]
    if need:
        scaled = _filter_top_k_top_p(scaled, top_k, top_p)
    return torch.softmax(scaled.to(torch.float32), dim=-1)


def _first_false(acc):
    """Per row, the index of the first False of ``acc [B, k]`` (``k``
    when every entry is True)."""
    pad = torch.zeros_like(acc[:, :1])
    return torch.argmin(torch.cat([acc, pad], dim=1).to(torch.int32), dim=1)


def _accept_and_draw(pr, q_probs, props, usable, u_acc, u_res):
    """The acceptance-rejection core, per row: test proposal ``i`` with
    ``u_acc[i] * q < p`` while ``i < usable``, find the first rejection
    ``m``, and draw the round's final token at ``u_res[m]``: from the
    normalised residual ``max(p_m - q_m, 0)`` at a NATURAL rejection
    (``m < usable``), else from the full target distribution ``p_m``
    (every usable proposal accepted, or a budget-capped round).

    ``pr``: warped target probs ``[B, k+1, V]``; ``q_probs`` the draft's
    ``[B, k, V]``; ``props [B, k]``; ``usable [B]``; the uniforms
    ``u_acc [B, k]``, ``u_res [B, k+1]`` (:func:`_round_uniforms`).
    Returns ``(m [B], final [B], dist [B, V])``, ``dist`` the
    distribution ``final`` was drawn from."""
    b, k, v = q_probs.shape
    ar = torch.arange(k, device=pr.device)
    p_at = pr[:, :k].gather(2, props[:, :, None])[:, :, 0]
    q_at = q_probs.gather(2, props[:, :, None])[:, :, 0]
    # u < p/q as u*q < p: no divide, exact at q == 0.
    acc = (u_acc * q_at < p_at) & (ar[None, :] < usable[:, None])
    m = _first_false(acc)
    rows = torch.arange(b, device=pr.device)
    pm = pr[rows, m]
    q_ext = torch.cat([q_probs, torch.zeros_like(q_probs[:, :1])], dim=1)
    natural = (m < usable)[:, None]
    r = torch.where(natural, torch.clamp(pm - q_ext[rows, m], min=0.0), pm)
    rsum = r.sum(dim=-1, keepdim=True)
    # A degenerate residual (p <= q everywhere, float ties) falls back
    # to the target distribution: a valid sample, unreachable exactly.
    r = torch.where(rsum > 0.0, r / rsum, pm / pm.sum(dim=-1, keepdim=True))
    final = _categorical(r, u_res.gather(1, m[:, None])[:, 0])
    return m, final, r


def _pack(props, m, final):
    """``[B, k + 2]``: the round's emitted tokens (``[:m]`` the accepted
    proposals, then ``final`` to the end of the width) and ``m``."""
    k = props.shape[1]
    ar = torch.arange(k + 1, device=props.device)
    ext = torch.cat([props, torch.zeros_like(props[:, :1])], dim=1)
    out = torch.where(ar[None, :] < m[:, None], ext, final[:, None])
    return torch.cat([out, m[:, None].to(out.dtype)], dim=1)


def _verify_pack_row(pr, q_probs, props, usable, u_acc, u_res):
    """:func:`_accept_and_draw` then :func:`_pack`: the sampled round's
    packed ``[B, k + 2]``."""
    m, final, _ = _accept_and_draw(pr, q_probs, props, usable, u_acc, u_res)
    return _pack(props, m, final)


def greedy_pack(props, expect, usable):
    """The greedy round's packed ``[B, k + 2]``: accept proposals while
    they equal the target's argmax ``expect [B, k+1]`` (and ``i <
    usable [B]``); the final token is the target's argmax after them."""
    k = props.shape[1]
    ar = torch.arange(k, device=props.device)
    acc = (props == expect[:, :k]) & (ar[None, :] < usable[:, None])
    m = _first_false(acc)
    return _pack(props, m, expect.gather(1, m[:, None])[:, 0])


# -- round pieces -------------------------------------------------------------

@torch.no_grad()
def verify_fn(model, cache, block, pos0, n_pad):
    """The greedy verify block: ``block [B, k+1]`` extended onto the
    target cache at ``pos0`` (an int, or per-row ``[B]``), in place;
    returns ``(cache, argmax [B, k+1])``."""
    cache, logits = model.extend_core(cache, block, pos0, n_pad, 0, 0,
                                      all_logits=True)
    return cache, torch.argmax(logits, dim=-1)


@torch.no_grad()
def propose_fn(model, cache, toks_in, pos0: int, n_pad, k: int,
               warp=None, u_draft=None):
    """One row's DRAFT phase: consume the ``n_in`` pending accepted
    tokens ``toks_in [n_in]`` (cache writes at ``pos0..``, in place) and
    chain ``k`` proposals (the last consume's output is proposal 1):
    ``n_in + k - 1`` draft steps. Greedy rows argmax; with ``warp``
    (:func:`_warp_args`) proposal ``j`` is drawn from the draft's warped
    distribution at ``u_draft[j]``. Returns ``(cache, proposals [k],
    q_probs [k, V] or None)``."""
    n_in = toks_in.shape[0]
    tok = toks_in[:1]
    props, qs = [], []
    for i in range(n_in + k - 1):
        logits, cache = model.decode_step(cache, tok[:, None], pos0 + i,
                                          n_pad)
        if i < n_in - 1:
            tok = toks_in[i + 1:i + 2]
            continue
        if warp is None:
            tok = torch.argmax(logits, dim=-1)
        else:
            probs = _warped_probs(logits, *warp)
            j = i - (n_in - 1)
            tok = _categorical(probs, u_draft[j:j + 1])
            qs.append(probs[0])
        props.append(tok[0])
    return cache, torch.stack(props), (torch.stack(qs) if qs else None)


@torch.no_grad()
def propose_batched_fn(model, cache, pend, n_in, d_pos, n_pad, k: int,
                       warp=None, u_draft=None):
    """The BATCHED draft phase with per-row positions: row ``b``
    consumes its ``n_in[b]`` ∈ {1, 2} pending tokens (``pend [B, 2]``)
    and chains ``k`` proposals, writing K/V at its own slots ``d_pos[b]
    + i``: ``k + 1`` steps for every row. A row with one pending token
    runs a trailing step whose output is never gathered; its write sits
    beyond the row's valid bound, masked until overwritten. Sampled
    rows (``warp``) draw step ``i`` at ``u_draft[b, max(i - n_in[b] +
    1, 0)]``. Returns ``(cache, proposals [B, k], q_probs [B, k, V] or
    None)``."""
    tok = pend[:, 0]
    toks, probs = [], []
    for i in range(k + 1):
        logits, cache = model.decode_step(cache, tok[:, None], d_pos + i,
                                          n_pad)
        if warp is None:
            nxt = torch.argmax(logits, dim=-1)
        else:
            pr = _warped_probs(logits, *warp)
            j = torch.clamp(i - (n_in - 1), min=0)
            nxt = _categorical(pr, u_draft.gather(1, j[:, None])[:, 0])
            probs.append(pr)
        toks.append(nxt)
        tok = torch.where(i + 1 < n_in, pend[:, min(i + 1, 1)], nxt)
    j = (n_in - 1)[:, None] + torch.arange(k, device=pend.device)[None, :]
    props = torch.stack(toks, dim=1).gather(1, j)
    if warp is None:
        return cache, props, None
    pr = torch.stack(probs, dim=1)
    q = pr.gather(1, j[:, :, None].expand(-1, -1, pr.shape[-1]))
    return cache, props, q


@torch.no_grad()
def sample_verify_batched_fn(model, cache, tok0, props, pos0, n_pad, q_probs,
                             warp, usable, u_acc, u_res):
    """The SAMPLED verify, every row at its own position: extend the
    target cache with ``[tok0, props]`` (``[B, k+1]``, in place), warp
    each position's logits as the draft's were, and run
    :func:`_accept_and_draw` per row. Returns ``(cache, packed [B,
    k+2])``."""
    block = torch.cat([tok0[:, None], props], dim=1)
    cache, logits = model.extend_core(cache, block, pos0, n_pad, 0, 0,
                                      all_logits=True)
    b, w, v = logits.shape
    temps, top_k, top_p, need = warp
    pr = _warped_probs(
        logits.reshape(b * w, v), temps.repeat_interleave(w),
        top_k.repeat_interleave(w), top_p.repeat_interleave(w), need,
    ).reshape(b, w, v)
    return cache, _verify_pack_row(pr, q_probs, props, usable, u_acc, u_res)


def sample_verify_fn(model, cache, tok0, props, pos0: int, n_pad, q_probs,
                     warp, usable, u_acc, u_res):
    """:func:`sample_verify_batched_fn` for one row: ``tok0 [1]``,
    ``props [k]``, ``q_probs [k, V]``, a scalar ``pos0``; returns
    ``(cache, packed [k+2])``."""
    cache, packed = sample_verify_batched_fn(
        model, cache, tok0, props[None], pos0, n_pad, q_probs[None], warp,
        usable, u_acc, u_res,
    )
    return cache, packed[0]


# -- library twins ----------------------------------------------------------

def _prefill(model, prompt_ids, total: int, seeds=None, temps=None,
             top_k=None, top_p=None):
    """A fresh ``[B, total]`` cache and the first token (greedy unless
    the warp vectors say otherwise, drawn at stream index 0)."""
    from mlapi_tpu_torch.models.gpt import prefill_fn

    b = prompt_ids.shape[0]
    n_pad = torch.zeros((b,), dtype=torch.long, device=prompt_ids.device)
    first, cache = prefill_fn(
        model, prompt_ids,
        np.zeros(b, np.int64) if seeds is None else seeds,
        np.zeros(b, np.float32) if temps is None else temps, n_pad,
        np.zeros(b, np.int64) if top_k is None else top_k,
        np.ones(b, np.float32) if top_p is None else top_p,
        total_len=total,
    )
    return first.tolist(), cache


def _plain_step(model, cache, tok: int, pos: int, seed=0, temp=0.0,
                step=0, top_k=0, top_p=1.0):
    """One plain target step at slot ``pos`` (sampled at the token's own
    plain stream index ``step``); returns ``(next_tok, cache)``."""
    from mlapi_tpu_torch.models.gpt import decode_chunk_fn

    dev = model.device
    toks, cache, _ = decode_chunk_fn(
        model, cache, torch.as_tensor([tok], device=dev), pos,
        torch.zeros((1,), dtype=torch.long, device=dev),
        np.asarray([temp], np.float32), np.asarray([seed], np.int64), step,
        np.asarray([top_k], np.int64), np.asarray([top_p], np.float32),
        chunk=1,
    )
    return int(toks[0, 0]), cache


def _check_pair(target, draft, prompt_ids, n: int) -> None:
    if target.vocab_size != draft.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    p = prompt_ids.shape[1]
    if p + n > target.max_positions or p + n > draft.max_positions:
        raise ValueError(
            f"prompt ({p}) + max_new_tokens ({n}) exceeds a model window"
        )


def _solo(target, draft, prompt_ids, max_new_tokens, k, sample):
    """The single-row round loop shared by :func:`speculative_generate`
    (``sample`` None) and :func:`speculative_sample` (``sample = (seed,
    temperature, top_k, top_p)``)."""
    prompt_ids = torch.as_tensor(prompt_ids, device=target.device).long()
    b, p = prompt_ids.shape
    if b != 1:
        raise ValueError("speculative decoding is single-row (batch=1)")
    n = int(max_new_tokens)
    _check_pair(target, draft, prompt_ids, n)
    k = max(1, min(int(k), n))
    # Room for a full round's block (t0 + k drafts) past the last needed
    # position keeps every verify the same width.
    total_t = min(target.max_positions, p + n + k + 1)
    total_d = min(draft.max_positions, p + n + k + 1)
    dev = target.device
    z_pad = torch.zeros((1,), dtype=torch.long, device=dev)
    seed, temp, top_k, top_p = sample or (0, 0.0, 0, 1.0)
    host = (np.asarray([seed], np.int64), np.asarray([temp], np.float32),
            np.asarray([top_k], np.int64), np.asarray([top_p], np.float32))
    warp = _warp_args(*host[1:], dev) if sample else None

    stats = SpecStats()
    # The target's first token is the plain path's (stream index 0).
    (t0,), t_cache = _prefill(target, prompt_ids, total_t, *host)
    _, d_cache = _prefill(draft, prompt_ids, total_d)
    out = [t0]
    # ``upto``: cache slots holding accepted content; ``pend``: accepted
    # tokens not yet in that model's cache (the draft's can be two
    # after a fully accepted round: its k-th proposal was never fed).
    t_upto, d_upto, d_pend = p, p, [t0]
    while len(out) < n:
        budget = n - len(out)
        room = (t_upto + 1 + k + 1 <= total_t
                and d_upto + len(d_pend) + k <= total_d)
        if budget == 1 or not room:
            # A plain target step; the draft is never consulted again
            # (budget and room only shrink), so its cache is not synced.
            nxt, t_cache = _plain_step(target, t_cache, out[-1], t_upto,
                                       seed, temp, len(out), top_k, top_p)
            t_upto += 1
            d_pend.append(nxt)
            out.append(nxt)
            stats.fallback_steps += 1
            continue
        step0 = len(out)
        usable = min(k, budget - 1)
        pend = torch.as_tensor(d_pend, device=dev)
        u = (torch.as_tensor(_round_uniforms([seed], [step0], k), device=dev)
             if sample else None)
        u_draft, u_acc, u_res = (_split_uniforms(u, k) if sample
                                 else (None, None, None))
        d_cache, props, q = propose_fn(
            draft, d_cache, pend, d_upto, z_pad, k, warp,
            None if u is None else u_draft[0])
        d_upto += len(d_pend) + k - 1
        use = torch.full((1,), usable, device=dev)
        if sample:
            t_cache, packed = sample_verify_fn(
                target, t_cache, pend[-1:], props, t_upto, z_pad, q, warp,
                use, u_acc, u_res)
        else:
            block = torch.cat([pend[-1:], props])[None]
            t_cache, expect = verify_fn(target, t_cache, block, t_upto,
                                        z_pad)
            packed = greedy_pack(props[None], expect, use)[0]
        packed = packed.tolist()  # the round's one read
        m = packed[k + 1]
        emitted = packed[:m + 1]
        out.extend(emitted)
        stats.rounds += 1
        stats.drafted += usable
        stats.accepted += m
        stats.emitted += m + 1
        stats.per_round.append(m + 1)
        t_upto += m + 1
        if m == k:
            d_pend = [packed[k - 1], emitted[-1]]
        else:
            # Rewind over the draft's rejected tail: later writes
            # overwrite it, ``idx <= pos`` masks it until then.
            d_upto = t_upto
            d_pend = [emitted[-1]]
    return out[:n], stats


def speculative_generate(target, draft, prompt_ids, *, max_new_tokens: int,
                         k: int = 4) -> tuple[list[int], SpecStats]:
    """Greedy speculative generation for ONE prompt row ``[1, P]`` (no
    padding): ``(token_ids, stats)``, the ids equal to plain target
    greedy decoding. Near the window edge it degrades to plain steps."""
    return _solo(target, draft, prompt_ids, max_new_tokens, k, None)


def speculative_sample(target, draft, prompt_ids, *, max_new_tokens: int,
                       k: int = 4, temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0,
                       seed: int = 0) -> tuple[list[int], SpecStats]:
    """SAMPLED speculative generation for ONE prompt row: distributed as
    plain target sampling under the same warp for any draft (the draft
    moves the acceptance rate, never the distribution), deterministic
    for a ``seed``. The first token and any plain step (a budget-1
    tail, the window edge) are the plain path's own draws.
    ``temperature <= 0`` is :func:`speculative_generate`."""
    if temperature <= 0.0:
        return speculative_generate(target, draft, prompt_ids,
                                    max_new_tokens=max_new_tokens, k=k)
    return _solo(target, draft, prompt_ids, max_new_tokens, k,
                 (int(seed), float(temperature), int(top_k), float(top_p)))


def _batched(target, draft, prompt_ids, max_new_tokens, k, sample):
    """The batched round loop shared by the two batched twins:
    ``sample`` None (greedy) or ``(seeds, temperature, top_k, top_p)``."""
    prompt_ids = torch.as_tensor(prompt_ids, device=target.device).long()
    b, p = prompt_ids.shape
    if target.vocab_size != draft.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    n = int(max_new_tokens)
    k = max(1, min(int(k), n))
    total = p + n + k + 1
    if total > target.max_positions or total > draft.max_positions:
        raise ValueError(
            f"batched speculation needs prompt + max_new_tokens + k + 1 "
            f"(= {total}) cache slots within both model windows; use "
            "the single-row variant near the window edge"
        )
    dev = target.device
    zb = torch.zeros((b,), dtype=torch.long, device=dev)
    if sample:
        seeds, temp, top_k, top_p = sample
        host = (np.asarray(seeds, np.int64), np.full(b, temp, np.float32),
                np.full(b, top_k, np.int64), np.full(b, top_p, np.float32))
        warp = _warp_args(*host[1:], dev)
    else:
        host, warp = (None,) * 4, None

    stats = SpecStats()
    first, t_cache = _prefill(target, prompt_ids, total, *host)
    _, d_cache = _prefill(draft, prompt_ids, total)
    out = [[t] for t in first]
    t_upto = np.full((b,), p, np.int64)
    d_upto = np.full((b,), p, np.int64)
    d_pend = [[t] for t in first]
    while any(len(o) < n for o in out):
        pend = np.zeros((b, 2), np.int64)
        n_in = np.ones((b,), np.int64)
        for i in range(b):
            n_in[i] = len(d_pend[i])
            pend[i, :n_in[i]] = d_pend[i]
        step0 = [len(o) for o in out]
        usable = [max(0, min(k, n - len(o) - 1)) for o in out]
        # One upload: pending tokens, counts, positions, budgets.
        ints = torch.as_tensor(
            np.concatenate([pend, n_in[:, None], d_upto[:, None],
                            t_upto[:, None], np.asarray(usable)[:, None]],
                           axis=1), device=dev)
        pend_t, n_in_t = ints[:, :2], ints[:, 2]
        d_pos, t_pos, use = ints[:, 3], ints[:, 4], ints[:, 5]
        if sample:
            u = torch.as_tensor(_round_uniforms(host[0], step0, k), device=dev)
            u_draft, u_acc, u_res = _split_uniforms(u, k)
        else:
            u_draft = None
        d_cache, props, q = propose_batched_fn(
            draft, d_cache, pend_t, n_in_t, d_pos, zb, k, warp, u_draft)
        d_upto += n_in + k - 1
        tok0 = torch.as_tensor([o[-1] for o in out], device=dev)
        if sample:
            t_cache, packed = sample_verify_batched_fn(
                target, t_cache, tok0, props, t_pos, zb, q, warp, use,
                u_acc, u_res)
        else:
            block = torch.cat([tok0[:, None], props], dim=1)
            t_cache, expect = verify_fn(target, t_cache, block, t_pos, zb)
            packed = greedy_pack(props, expect, use)
        packed = packed.tolist()  # the round's one read
        stats.rounds += 1
        for i in range(b):
            if n - len(out[i]) <= 0:
                # A finished row rides as a dummy: its writes sit beyond
                # its valid bound.
                d_upto[i] = t_upto[i]
                continue
            m = packed[i][k + 1]
            emitted = packed[i][:m + 1]
            out[i].extend(emitted)
            stats.drafted += usable[i]
            stats.accepted += m
            stats.emitted += m + 1
            t_upto[i] += m + 1
            if m == k:
                d_pend[i] = [packed[i][k - 1], emitted[-1]]
            else:
                d_upto[i] = t_upto[i]
                d_pend[i] = [emitted[-1]]
    return [o[:n] for o in out], stats


def speculative_generate_batched(target, draft, prompt_ids, *,
                                 max_new_tokens: int, k: int = 4):
    """Greedy speculative generation for a WHOLE BATCH of unpadded
    prompt rows, each advancing by its own acceptance length (per-row
    cache positions): every row's stream equals its plain greedy stream.
    A finished row rides as a dummy until every row is done. Needs
    ``prompt + max_new_tokens + k + 1`` slots in both windows
    (``ValueError`` otherwise). Returns ``(streams, stats)``."""
    return _batched(target, draft, prompt_ids, max_new_tokens, k, None)


def speculative_sample_batched(target, draft, prompt_ids, *,
                               max_new_tokens: int, k: int = 4,
                               temperature: float = 1.0, top_k: int = 0,
                               top_p: float = 1.0, seeds=None):
    """SAMPLED speculative generation for a whole batch, row ``b``
    seeded by ``seeds[b]`` (default ``b``): each row's stream is
    distributed as plain target sampling, and a budget-1 tail is a
    ``usable = 0`` round (a draw from the full target distribution).
    ``temperature <= 0`` is :func:`speculative_generate_batched`."""
    if temperature <= 0.0:
        return speculative_generate_batched(
            target, draft, prompt_ids, max_new_tokens=max_new_tokens, k=k)
    b = len(prompt_ids)
    seeds = list(range(b)) if seeds is None else list(seeds)
    if len(seeds) != b:
        raise ValueError(f"need {b} seeds, got {len(seeds)}")
    return _batched(target, draft, prompt_ids, max_new_tokens, k,
                    (seeds, float(temperature), int(top_k), float(top_p)))
