"""The host-loop speculative-decoding phase of generative serving.

Counterpart of ``mlapi_tpu/serving/spec_phase.py``. One :class:`SpecPhase`
per :class:`~mlapi_tpu_torch.serving.engine.TextGenerationEngine` runs
the draft-propose / target-verify rounds of a batch: solo
(:meth:`run_solo`) and batched (:meth:`run_batched`), plus a startup
warm (:meth:`warm`). ``BatchRun`` hands it the live target cache and
host mirrors at a round boundary and resumes chunked decoding from the
``(cache, pos)`` it returns; the yield test is the engine's
``_spec_should_yield``. The draft's cache is contiguous, in the draft's
own format (``from_checkpoint`` gives it the target's ``kv_quant`` and
``decode_attn_impl``). The round pieces and the library twins live in
``ops/speculative.py``.

The reference's ``_rebind_pool`` has no counterpart: the port's pool
tensors are written in place and never donated.
"""

from __future__ import annotations

import numpy as np
import torch

from mlapi_tpu_torch.serving import faults


class SpecPhase:
    def __init__(self, engine):
        self.eng = engine

    def _draft_prefill(self, prompt, n_pad, total: int):
        """A fresh contiguous draft cache over the batch's padded prompt
        rows (pads masked as the target's)."""
        from mlapi_tpu_torch.models.gpt import prefill_fn

        b = prompt.shape[0]
        dev = self.eng.device
        _, cache = prefill_fn(
            self.eng.draft_model,
            torch.as_tensor(prompt, dtype=torch.long, device=dev),
            np.zeros(b, np.int64), np.zeros(b, np.float32), n_pad,
            np.zeros(b, np.int64), np.ones(b, np.float32), total_len=total,
        )
        return cache

    def run_solo(self, r, cache, pos, total, bucket, tok, step, produced,
                 n_pad, seeds, history, temps, topk, topp, ensure=None):
        """Speculative rounds for a single request against the live
        target cache; returns ``(cache, pos)`` for the chunk loop to
        resume from, and updates the host mirrors ``tok``, ``step`` and
        ``produced`` in place. Greedy rows emit the target's greedy
        stream; sampled rows (under ``spec_sample``) are distributed as
        target sampling. ``history`` (the row's emitted tokens) replays
        into a fresh draft cache, so a stream whose transient joiners
        left speculates again for its tail.

        ``ensure`` (paged targets): ``cache = ensure(cache, lo, hi)``
        maps virtual slots ``[lo, hi)`` to pool pages before each verify
        block writes them."""
        from mlapi_tpu_torch.models.gpt import extend_chunk_fn
        from mlapi_tpu_torch.ops.speculative import (
            _round_uniforms, _split_uniforms, _warp_args, greedy_pack,
            propose_fn, sample_verify_fn, verify_fn,
        )

        eng = self.eng
        k = eng.spec_k
        # Cheap disqualifiers before any device work: nothing to
        # speculate, no block room, or other work waiting.
        if r.n_new - produced[0] <= 1 or pos + 1 + k + 1 > total:
            return cache, pos
        if eng._spec_should_yield():
            return cache, pos
        dev = eng.device
        npj = torch.as_tensor(n_pad[:1], dtype=torch.long, device=dev)
        row = np.full((1, bucket), eng.tokenizer.pad_id, np.int64)
        row[0, bucket - len(r.row):] = r.row
        d_cache = self._draft_prefill(row, npj, total)
        # Replay the emitted tokens (all but the unconsumed last, which
        # seeds the first round) in chunk-wide blocks, then single steps.
        replay = history[:-1]
        at = bucket
        ri = 0
        while len(replay) - ri >= eng.chunk:
            blk = torch.as_tensor([replay[ri:ri + eng.chunk]], device=dev)
            d_cache, _ = extend_chunk_fn(eng.draft_model, d_cache, blk, at,
                                         npj)
            at += eng.chunk
            ri += eng.chunk
        with torch.no_grad():
            for t in replay[ri:]:
                _, d_cache = eng.draft_model.decode_step(
                    d_cache, torch.as_tensor([[t]], device=dev), at, npj)
                at += 1

        sampled = bool(temps[0] > 0.0)
        warp = _warp_args(temps[:1], topk[:1], topp[:1], dev) if sampled \
            else None
        seed = int(seeds[0])
        d_upto = t_upto = pos
        d_pend = [int(tok[0])]
        while not r.cancelled and produced[0] < r.n_new:
            if eng._expire_if_due(r, "decode"):
                break  # a round boundary is a deadline boundary
            if eng._spec_should_yield():
                break  # joiners or other lanes wait: the chunk loop
            budget = r.n_new - produced[0]
            if budget <= 1 or t_upto + 1 + k + 1 > total:
                break
            if ensure is not None:
                # The verify block writes [t_upto, t_upto + k + 1).
                cache = ensure(cache, t_upto, t_upto + k + 1)
            step0 = int(produced[0])
            usable = min(k, budget - 1)
            pend = torch.as_tensor(d_pend, device=dev)
            use = torch.full((1,), usable, device=dev)
            if sampled:
                u = torch.as_tensor(_round_uniforms([seed], [step0], k),
                                    device=dev)
                u_draft, u_acc, u_res = _split_uniforms(u, k)
                d_cache, props, q = propose_fn(
                    eng.draft_model, d_cache, pend, d_upto, npj, k, warp,
                    u_draft[0])
            else:
                d_cache, props, _ = propose_fn(
                    eng.draft_model, d_cache, pend, d_upto, npj, k)
            d_upto += len(d_pend) + k - 1
            faults.fire("spec_verify")
            if sampled:
                cache, packed = sample_verify_fn(
                    eng.model, cache, pend[-1:], props, t_upto, npj, q,
                    warp, use, u_acc, u_res)
            else:
                block = torch.cat([pend[-1:], props])[None]
                cache, expect = verify_fn(eng.model, cache, block, t_upto,
                                          npj)
                packed = greedy_pack(props[None], expect, use)[0]
            packed = packed.tolist()  # the round's one read
            m = packed[k + 1]
            emitted = packed[:m + 1]
            r.push({"token_ids": emitted})
            history.extend(emitted)  # keeps the replay state current
            produced[0] += m + 1
            step[0] = produced[0]
            t_upto += m + 1
            tok[0] = emitted[-1]
            eng.spec_rounds += 1
            eng.spec_drafted += usable
            eng.spec_accepted += m
            if m == k:
                # The draft never cached its k-th proposal.
                d_pend = [packed[k - 1], emitted[-1]]
            else:
                d_upto = t_upto
                d_pend = [emitted[-1]]
        return cache, t_upto

    def run_batched(self, reqs, cache, pos, total, prompt, tok, step,
                    produced, done, n_pad, b_cur, ensure=None,
                    paged_realign=None):
        """Speculative rounds for a WHOLE freshly formed greedy batch:
        every row drafts k proposals and verifies them in one block per
        round, advancing by its OWN acceptance length (per-row
        positions). Finished or cancelled rows freeze and ride as
        dummies, their writes beyond their valid bound.

        Handoff: the phase ends at a round boundary when other work
        waits (or every row is done) and REALIGNS the cache: row ``b``
        rolls right by ``max(t_upto) - t_upto_b`` and ``n_pad[b]`` (the
        host mirror, updated in place) grows by as much, which keeps
        every effective position, so the scalar-``pos`` chunk loop
        resumes as if the batch had always been in step. Paged targets
        pass ``ensure`` (as :meth:`run_solo`) and ``paged_realign(cache,
        delta, top)`` in place of ``realign_fn``. Returns ``(cache,
        pos)``."""
        from mlapi_tpu_torch.models.gpt import realign_fn
        from mlapi_tpu_torch.ops.speculative import (
            greedy_pack, propose_batched_fn, verify_fn,
        )

        eng = self.eng
        k = eng.spec_k
        if eng._spec_should_yield():
            return cache, pos  # skip the whole-batch draft prefill too
        dev = eng.device
        npj = torch.as_tensor(n_pad, dtype=torch.long, device=dev)
        d_cache = self._draft_prefill(prompt, npj, total)

        b = len(reqs)
        t_upto = np.full((b_cur,), pos, np.int64)
        d_upto = np.full((b_cur,), pos, np.int64)
        d_pend = [[int(tok[i])] for i in range(b_cur)]
        while True:
            if eng._spec_should_yield():
                break  # joiners waiting: realign and hand off
            for i in range(b):
                if not done[i]:
                    # Expired rows cancel (terminal frame) and freeze.
                    eng._expire_if_due(reqs[i], "decode")
            active = [
                i for i in range(b)
                if not done[i] and not reqs[i].cancelled
                and reqs[i].n_new - produced[i] >= 1
            ]
            if not active:
                break
            # The realign frontier (max position, growing by <= k + 1)
            # plus the laggiest row's remaining budget must still fit
            # the cache after any round, or the chunk loop would
            # truncate a slow row: stop one round early instead.
            rem = max(reqs[i].n_new - produced[i] for i in active)
            if int(t_upto.max()) + k + 1 + rem - 1 > total:
                break
            pend = np.zeros((b_cur, 2), np.int64)
            n_in = np.ones((b_cur,), np.int64)
            usable = np.zeros((b_cur,), np.int64)
            for i in range(b_cur):
                n_in[i] = len(d_pend[i])
                pend[i, :n_in[i]] = d_pend[i]
            for i in active:
                usable[i] = min(k, reqs[i].n_new - produced[i] - 1)
            if ensure is not None:
                # Every row's verify block writes [t_upto_b, + k + 1).
                cache = ensure(cache, int(t_upto.min()),
                               int(t_upto.max()) + k + 1)
            # One upload: pending tokens, counts, positions, budgets, and
            # each row's last token.
            ints = torch.as_tensor(np.concatenate(
                [pend, n_in[:, None], d_upto[:, None], t_upto[:, None],
                 usable[:, None], np.asarray(tok[:b_cur], np.int64)[:, None]],
                axis=1), device=dev)
            d_cache, props, _ = propose_batched_fn(
                eng.draft_model, d_cache, ints[:, :2], ints[:, 2],
                ints[:, 3], npj, k)
            d_upto += n_in + k - 1
            faults.fire("spec_verify")
            block = torch.cat([ints[:, 6:7], props], dim=1)
            cache, expect = verify_fn(eng.model, cache, block, ints[:, 4],
                                      npj)
            packed = greedy_pack(props, expect, ints[:, 5]).tolist()
            eng.spec_rounds += 1
            for i in active:
                r = reqs[i]
                m = packed[i][k + 1]
                emitted = packed[i][:m + 1]
                r.push({"token_ids": emitted})
                produced[i] += m + 1
                step[i] = produced[i]
                t_upto[i] += m + 1
                tok[i] = emitted[-1]
                eng.spec_drafted += int(usable[i])
                eng.spec_accepted += m
                if m == k:
                    d_pend[i] = [packed[i][k - 1], emitted[-1]]
                else:
                    d_upto[i] = t_upto[i]
                    d_pend[i] = [emitted[-1]]
                if produced[i] >= r.n_new:
                    r.push(None)
                    done[i] = True
            for i in range(b_cur):
                if i >= b or done[i] or reqs[i].cancelled:
                    # Frozen and dummy rows keep their state pinned, so
                    # the realign delta stays right.
                    d_upto[i] = t_upto[i]
                    d_pend[i] = d_pend[i][-1:]

        top = int(t_upto.max())
        if int(t_upto.min()) < top:
            delta = top - t_upto
            if paged_realign is not None:
                cache = paged_realign(cache, delta, top)
            else:
                cache = realign_fn(cache, delta)
            n_pad[:b_cur] += delta  # in place: the chunk loop's mirror
        return cache, top

    def warm(self) -> int:
        """Run the phase's device work once before serving, so the first
        speculating request pays no one-time cost (kernel loads, the
        allocator's first blocks): a draft prefill at the smallest
        bucket, one greedy round (propose from one and from two pending
        tokens, the verify block) against a throwaway target cache (for
        a paged engine, the pool through a null table: the writes land
        in the null page), and the realign. Returns the shapes run."""
        from mlapi_tpu_torch.models.gpt import paged_realign_fn, realign_fn
        from mlapi_tpu_torch.ops.quant import paged_cache_tree
        from mlapi_tpu_torch.ops.speculative import (
            propose_batched_fn, propose_fn, verify_fn,
        )

        eng = self.eng
        k = eng.spec_k
        bucket = eng.prompt_buckets[0]
        total = eng._cache_len(bucket, eng.default_max_new_tokens)
        if bucket + 1 + k + 1 > total:
            return 0
        dev = eng.device
        shapes = 0
        with torch.inference_mode():
            for bsz in (1, 2) if eng.max_batch > 1 else (1,):
                npj = torch.full((bsz,), bucket - 1, dtype=torch.long,
                                 device=dev)
                row = np.full((bsz, bucket), eng.tokenizer.pad_id, np.int64)
                d_cache = self._draft_prefill(row, npj, total)
                if eng.pool is None:
                    t_cache = eng.model.init_cache(bsz, total)
                else:
                    npv = -(-total // eng.pool.page)
                    t_cache = paged_cache_tree(
                        eng.pool.layers, np.zeros((bsz, npv), np.int32))
                zeros = torch.zeros((bsz, k + 1), dtype=torch.long,
                                    device=dev)
                if bsz == 1:
                    for n_in in (1, 2):
                        d_cache, _, _ = propose_fn(
                            eng.draft_model, d_cache, zeros[0, :n_in],
                            bucket, npj, k)
                    verify_fn(eng.model, t_cache, zeros, bucket, npj)
                else:
                    at = torch.full((bsz,), bucket, dtype=torch.long,
                                    device=dev)
                    propose_batched_fn(eng.draft_model, d_cache,
                                       zeros[:, :2], zeros[:, 0] + 1, at,
                                       npj, k)
                    verify_fn(eng.model, t_cache, zeros, at, npj)
                    delta = np.zeros(bsz, np.int64)
                    if eng.pool is None:
                        realign_fn(t_cache, delta)
                    else:
                        paged_realign_fn(t_cache, delta)
                shapes += 1
        return shapes
