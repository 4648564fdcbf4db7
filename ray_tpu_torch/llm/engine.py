"""Continuous-batching inference engine (port of ray_tpu/llm/engine.py).

Same design as the reference:

- The KV cache is ONE static-shape tensor pair [L, B, S, KVH, HD] on
  the device; slot b of the batch dimension is assigned to one request
  at a time.
- Decode is one step for the WHOLE batch every iteration; requests join
  (blocking prefill into a free slot, or chunk by chunk) and leave (stop
  id / length) between steps.
- Prefill pads prompts into power-of-two buckets.
- Sampling (greedy / temperature / top-k, plus a per-slot logit_bias
  row) runs on the device; only the sampled ids cross to the host.
- Scheduling features, as in the reference: multi-LoRA (a bank of
  adapters gathered per slot at decode), multi-step decode, speculative
  decoding with a draft model, prefix caching and chunked prefill. The
  last three score chunks with ``llama_verify_step``; all but LoRA park
  idle slots' writes in a scratch region at the cache's tail.

What differs: JAX donates the cache buffers to each jitted program; here
prefill inserts and every batched step write IN PLACE into the one
preallocated cache pair, so a cached prefix is copied into a fresh tensor
before a verify step writes over it. Random draws come from one
``torch.Generator`` on the engine's device seeded from ``config.seed``,
so sampled ids differ from the reference's ``jax.random`` ids (greedy
ids do not). Multi-step decode is K calls of the decode step in a row
(the reference scans them inside one jitted program).

Not ported yet: guided decoding, penalties, logprobs, ``embed``,
disaggregated prefill/decode (``prefill_only`` / ``add_prefilled``),
metrics and the flight recorder.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import DeviceLike, device_of, resolve_device
from ray_tpu_torch.models.llama import (
    LlamaConfig, llama_decode_step, llama_init, llama_init_cache,
    llama_prefill, llama_verify_step, quantize_llama_ffn)


class EngineSaturatedError(RuntimeError):
    """Raised by add_request when the waiting queue is at
    EngineConfig.max_waiting_requests (reject before enqueue)."""

    def __init__(self, waiting: int, cap: int):
        self.waiting = waiting
        self.cap = cap
        super().__init__(
            f"engine waiting queue is full ({waiting}/{cap}); "
            "retry after the batch drains")


@dataclass
class EngineConfig:
    # default vocab covers the ByteTokenizer's 258 ids (256 bytes + BOS/EOS)
    model: LlamaConfig = field(
        default_factory=lambda: LlamaConfig.tiny(vocab_size=258))
    max_batch: int = 8
    max_seq: int = 512
    seed: int = 0
    # multi-LoRA bank size (adapter slot 0 is the zero/base adapter);
    # 0 disables the LoRA path (no bank in the decode step)
    max_loras: int = 0
    lora_rank: int = 8
    # "int8": weight-only int8 FFN stacks of the target model
    # (per-output-channel scales, kernel K5 on the card). None serves in
    # the working dtype.
    quantization: Optional[str] = None
    # Static top-k width for on-device sampling; per-request top_k is
    # CLAMPED to it at add_request. top_k=0 samples the full vocab.
    max_top_k: int = 256
    # Speculative decoding: a draft model greedily proposes
    # spec_tokens-1 tokens per round and the target scores the whole
    # chunk in ONE llama_verify_step forward, up to spec_tokens tokens
    # per target forward. Greedy requests speculate; sampled requests
    # get one target-sampled token per round. None disables. Every
    # emitted greedy token is the argmax of the TARGET's verify logits;
    # in bf16 the verify step may break argmax ties differently from
    # the decode step (exact parity with the dense path holds in f32).
    draft_model: Optional[LlamaConfig] = None
    spec_tokens: int = 4
    # Multi-step decode: multi_step decode steps per host round trip
    # (the sampled ids stay on the device between them and cross once,
    # as [K, B]). Tokens past a stop or max_tokens are discarded on the
    # host, so greedy outputs equal single-step decoding. Mutually
    # exclusive with draft_model.
    multi_step: int = 1
    # Automatic prefix caching: completed prompts' K/V blocks are kept
    # in an LRU keyed by their tokens; a prompt sharing a cached prefix
    # prefills ONLY its suffix (one llama_verify_step chunk at the
    # prefix boundary). Entries hold device memory. LoRA prefills
    # bypass the cache (adapter K/V must not leak across adapters).
    enable_prefix_caching: bool = False
    prefix_cache_entries: int = 16
    prefix_cache_min_tokens: int = 8
    # Chunked prefill: prompts prefill this many tokens per step, in the
    # same llama_verify_step dispatch that decodes the other slots, so
    # a long prompt joining stalls the batch by one chunk forward, not
    # the whole prompt. 0 disables. Mutually exclusive with draft_model
    # and enable_prefix_caching; adapter requests take the blocking
    # prefill.
    chunked_prefill_tokens: int = 0
    # add_request raises EngineSaturatedError instead of appending once
    # this many requests are waiting. 0 disables (unbounded waiting).
    max_waiting_requests: int = 0


@dataclass
class GenerationRequest:
    prompt_ids: List[int]
    max_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    stop_ids: tuple = ()
    # OpenAI-style logit bias: {token_id: bias} added to the target
    # logits before sampling, every step and on every path (values
    # clamped to +-100). Drafts propose without it.
    logit_bias: Optional[Dict[int, float]] = None
    # LoRA adapter name (must be register_adapter'd); None = base model
    adapter: Optional[str] = None
    request_id: int = field(default_factory=itertools.count().__next__)
    # Streaming: when set (queue.Queue), each emitted token is pushed as
    # it decodes; None terminates the stream.
    stream_queue: Optional[Any] = None
    # filled by the engine
    output_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    done_event: threading.Event = field(default_factory=threading.Event,
                                        repr=False, compare=False)

    @property
    def done(self) -> bool:
        return self.finish_reason is not None

    def finish(self, reason: str, error: Optional[str] = None) -> None:
        """Mark finished and wake waiters (the one completion path)."""
        if error is not None:
            self.error = error
        self.finish_reason = reason
        self.done_event.set()

    def wait_done(self, timeout: Optional[float] = None) -> bool:
        """Block until the engine finishes this request. Returns
        ``done`` (False on timeout)."""
        self.done_event.wait(timeout)
        return self.done

    def push_stream(self, item) -> None:
        if self.stream_queue is not None:
            try:
                self.stream_queue.put_nowait(item)
            except Exception:  # graftlint: disable=GL004
                pass  # stream consumer is gone; tokens just drop


class _Slot:
    def __init__(self, index: int):
        self.index = index
        self.request: Optional[GenerationRequest] = None
        self.pos = 0            # position of the NEXT token to decode
        self.next_token = 0
        # False when the draft cache lacks this slot's prompt; no
        # speculation while such a slot is active. Every admission path
        # of this engine prefills the draft, so it stays True.
        self.draft_ready = True
        # chunked prefill: prompt tokens still being prefilled
        self.prefilling = False
        self.prefill_ids: Optional[List[int]] = None
        self.prefill_pos = 0


@torch.no_grad()
def sample_tokens(logits: torch.Tensor, temp: torch.Tensor,
                  topk: torch.Tensor, generator: torch.Generator,
                  max_k: int, bias: Optional[torch.Tensor] = None):
    """On-device sampling, [B, V] logits -> [B] int64: greedy where
    temp <= 0, else temperature sampling over the full vocab (topk 0)
    or over the top min(topk, max_k) ids. ``bias`` [B, V] is added
    first."""
    if bias is not None:
        logits = logits + bias
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temp, min=1e-6)[:, None]
    full = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                             generator=generator)[:, 0]
    vals, idx = torch.topk(scaled, max_k, dim=-1)
    keep = (torch.arange(max_k, device=logits.device)[None, :]
            < torch.clamp(topk, 1, max_k)[:, None])
    vals = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                               generator=generator)
    topk_tok = torch.gather(idx, 1, choice)[:, 0]
    sampled = torch.where(topk > 0, topk_tok, full)
    return torch.where(temp <= 0.0, greedy, sampled)


def _validate_config(config: EngineConfig) -> int:
    """The reference's refusals, in its order, before any memory is
    taken. Returns the rows of the scratch region."""
    if config.quantization is not None and config.quantization != "int8":
        raise ValueError(f"unknown quantization {config.quantization!r} "
                         "(supported: \"int8\")")
    spec = config.draft_model is not None
    if spec:
        if config.draft_model.vocab_size != config.model.vocab_size:
            raise ValueError(
                "draft_model vocab_size must match the target's")
        if config.spec_tokens < 2:
            raise ValueError("spec_tokens must be >= 2 (1 draft + "
                             "1 verified token minimum)")
    scratch = max(config.spec_tokens if spec else 0,
                  config.chunked_prefill_tokens,
                  config.multi_step if config.multi_step > 1 else 0)
    if config.max_seq - 1 - scratch < 1:
        raise ValueError(
            f"max_seq={config.max_seq} leaves no usable positions "
            f"after the {scratch}-row scratch region")
    if config.chunked_prefill_tokens > 0:
        if spec:
            raise ValueError("chunked_prefill_tokens and "
                             "draft_model are mutually exclusive")
        if config.enable_prefix_caching:
            raise ValueError("chunked_prefill_tokens and "
                             "enable_prefix_caching are mutually "
                             "exclusive")
    if config.multi_step > 1 and spec:
        raise ValueError(
            "multi_step and draft_model are mutually exclusive")
    return scratch


class ContinuousBatchingEngine:
    def __init__(self, config: EngineConfig, params=None,
                 draft_params=None, device: DeviceLike = None):
        self.config = config
        c = config.model
        scratch = _validate_config(config)
        self.device = resolve_device(device)
        params = self._own_params(params, c, config.seed)
        if config.quantization is not None and \
                "w1_q8" not in params["layers"]:
            # pre-quantized weights (w1_q8 present) load as they are
            params = quantize_llama_ffn(params, c)
        self.params = params
        self.cache_k, self.cache_v = llama_init_cache(
            c, config.max_batch, config.max_seq, self.device)
        # per-slot logit_bias rows on the device: one [B, V] add per
        # step; rows are (re)set at admission
        self._bias = torch.zeros((config.max_batch, c.vocab_size),
                                 dtype=torch.float32, device=self.device)
        self._spec = config.draft_model is not None
        if self._spec:
            self.draft_params = self._own_params(
                draft_params, config.draft_model, config.seed + 1)
            self.draft_cache_k, self.draft_cache_v = llama_init_cache(
                config.draft_model, config.max_batch, config.max_seq,
                self.device)
            # greedy drafts proposed and accepted by the target
            self.spec_proposed = 0
            self.spec_accepted = 0
        # Scratch region: every batched dispatch writes K/V rows for ALL
        # slots, so slots not taking part park their writes in the
        # cache tail. Those rows never hold live history: rows below a
        # slot's position are attended without being rewritten. The
        # region fits the widest parked write (spec chunk, prefill
        # chunk, multi-step burst), and requests retire before it.
        self._pos_limit = config.max_seq - 1 - scratch
        # Without a scratch region idle slots park at row 0 (they hold
        # no live rows, and the next prefill insert rewrites row 0), so
        # the whole max_seq-1 context stays usable. With one, parking
        # moves to the tail, because a PREFILLING slot's low rows are
        # live.
        self._dense_park = config.max_seq - 1 if scratch else 0
        self.slots = [_Slot(i) for i in range(config.max_batch)]
        self.waiting: List[GenerationRequest] = []
        self._lock = threading.Lock()
        self.total_generated = 0
        # sampling dispatches (prefills, decode rounds, verify and chunk
        # steps); the reference folds its RNG key with this count
        self._step_counter = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        self._max_k = min(config.max_top_k, c.vocab_size)
        # multi-LoRA bank: slot 0 is the all-zero base adapter, so "no
        # adapter" needs no branch in the decode step
        self._adapters: Dict[str, int] = {}
        self._adapter_prefill: Dict[str, Dict[str, torch.Tensor]] = {}
        self._next_adapter_slot = 1
        self.lora_bank: Optional[Dict[str, torch.Tensor]] = None
        if config.max_loras > 0:
            n, r = config.max_loras + 1, config.lora_rank
            hd = c.head_dim

            def zeros(*shape):
                return torch.zeros(shape, dtype=c.dtype, device=self.device)

            self.lora_bank = {
                "A_q": zeros(n, c.n_layers, c.dim, r),
                "B_q": zeros(n, c.n_layers, r, c.n_heads * hd),
                "A_v": zeros(n, c.n_layers, c.dim, r),
                "B_v": zeros(n, c.n_layers, r, c.n_kv_heads * hd),
                # per-adapter scales are folded into B at registration
                "scale": torch.tensor(1.0, dtype=c.dtype,
                                      device=self.device),
            }
        self._prefix_cache = None
        if config.enable_prefix_caching:
            # token tuple -> (ids array, ks, vs); LRU, device-resident
            self._prefix_cache = collections.OrderedDict()
            self.prefix_hits = 0
            self.prefix_misses = 0

    def _own_params(self, params, model: LlamaConfig, seed: int):
        """``params`` checked to live on the engine's device, or random
        weights from ``seed`` made there."""
        if params is None:
            return llama_init(seed, model, self.device)
        if device_of(params) != self.device:
            raise ValueError(f"params live on {device_of(params)}, the "
                             f"engine on {self.device}")
        return params

    # ------------------------------------------------------------------
    def register_adapter(self, name: str, lora_params) -> None:
        """Install a LoRA adapter (``lora_init``'s dict) into the bank
        under ``name``. Its alpha/rank scale is folded into B, and its
        rank zero-padded up to the bank's (the extra zero columns change
        nothing), so the decode step carries no per-adapter scale."""
        if self.lora_bank is None:
            raise ValueError("engine built with max_loras=0")
        dtype = self.config.model.dtype
        scale = float(lora_params.get("scale", 1.0))
        folded = {part: torch.as_tensor(lora_params[part]).to(
            device=self.device) for part in ("A_q", "B_q", "A_v", "B_v")}
        folded["B_q"] = folded["B_q"] * scale
        folded["B_v"] = folded["B_v"] * scale
        rank = int(folded["A_q"].shape[-1])
        bank_rank = self.config.lora_rank
        if rank > bank_rank:
            raise ValueError(
                f"adapter rank {rank} exceeds the engine's lora_rank "
                f"{bank_rank}")
        pad = bank_rank - rank
        for part in ("A_q", "A_v"):
            folded[part] = F.pad(folded[part], (0, pad))
        for part in ("B_q", "B_v"):
            folded[part] = F.pad(folded[part], (0, 0, 0, pad))
        # Every shape is checked BEFORE a slot is reserved: a failed
        # registration must not leak a bank slot.
        for part in ("A_q", "B_q", "A_v", "B_v"):
            want = tuple(self.lora_bank[part].shape[1:])
            got = tuple(folded[part].shape)
            if got != want:
                raise ValueError(
                    f"adapter {part} shape {got} does not match the "
                    f"engine's bank slot shape {want} (built for a "
                    "different model config?)")
            folded[part] = folded[part].to(dtype)
        folded["scale"] = torch.tensor(1.0, dtype=dtype, device=self.device)
        # Publish a COMPLETE new bank dict in one reference swap, under
        # the lock: the stepper reads self.lora_bank once per step and
        # sees the old or the new bank, never mismatched factors; the
        # lock keeps concurrent registrations from losing a write.
        with self._lock:
            idx = self._adapters.get(name)
            if idx is None:
                idx = self._next_adapter_slot
                if idx > self.config.max_loras:
                    raise ValueError(
                        f"LoRA bank full ({self.config.max_loras}); "
                        "raise max_loras")
                self._next_adapter_slot += 1
            new_bank = dict(self.lora_bank)
            for part in ("A_q", "B_q", "A_v", "B_v"):
                new_bank[part] = self.lora_bank[part].clone()
                new_bank[part][idx] = folded[part]
            self.lora_bank = new_bank
            self._adapter_prefill[name] = folded
            self._adapters[name] = idx

    def _adapter_index(self, request: GenerationRequest) -> int:
        if request.adapter is None:
            return 0
        idx = self._adapters.get(request.adapter)
        if idx is None:
            raise ValueError(f"unknown LoRA adapter {request.adapter!r}")
        return idx

    def add_request(self, request: GenerationRequest) -> GenerationRequest:
        request._t_submit = time.perf_counter()
        self._validate_logit_bias(request.logit_bias)
        limit = self._pos_limit
        if len(request.prompt_ids) > limit:
            request.prompt_ids = request.prompt_ids[-limit:]
        if request.adapter is not None:
            # fail fast on the caller's thread: a raise in the stepper
            # would fail every request
            self._adapter_index(request)
        if request.top_k > self.config.max_top_k:
            # the sampler's static width bounds per-request top-k; make
            # the effective value visible rather than silently narrower
            request.top_k = self.config.max_top_k
        with self._lock:
            cap = self.config.max_waiting_requests
            if cap > 0 and len(self.waiting) >= cap:
                waiting = len(self.waiting)
            else:
                waiting = None
                self.waiting.append(request)
        if waiting is not None:
            raise EngineSaturatedError(waiting, cap)
        return request

    def has_work(self) -> bool:
        with self._lock:
            return (bool(self.waiting)
                    or any(s.request is not None for s in self.slots))

    def _free_slots(self) -> List[_Slot]:
        return [s for s in self.slots if s.request is None]

    def _validate_logit_bias(self, logit_bias) -> None:
        """Reject out-of-vocab ids on the caller's thread (a raise in
        the stepper would fail every request)."""
        if not logit_bias:
            return
        vocab = self.config.model.vocab_size
        for tid in logit_bias:
            if not 0 <= int(tid) < vocab:
                raise ValueError(
                    f"logit_bias token id {tid} outside vocab "
                    f"[0, {vocab})")

    def _bias_row(self, request: GenerationRequest) -> np.ndarray:
        """Dense [V] f32 row from the request's sparse logit_bias,
        values clamped to the OpenAI +-100 range."""
        row = np.zeros(self.config.model.vocab_size, dtype=np.float32)
        for tid, val in (request.logit_bias or {}).items():
            row[int(tid)] = float(np.clip(val, -100.0, 100.0))
        return row

    def _install_bias(self, request: GenerationRequest,
                      slot_index: int) -> None:
        if request.logit_bias:
            self._bias[slot_index] = torch.from_numpy(
                self._bias_row(request)).to(self.device)
        else:
            self._bias[slot_index].zero_()

    def _bucket_len(self, n: int) -> int:
        bucket = 1
        while bucket < n:
            bucket *= 2
        return min(bucket, self.config.max_seq)

    def _pad_bucket(self, ids: List[int]) -> np.ndarray:
        """Power-of-two bucket/pad a prompt (one policy for the target
        and the draft prefills)."""
        bucket = self._bucket_len(len(ids))
        padded = np.zeros((1, bucket), dtype=np.int64)
        padded[0, : len(ids)] = ids
        return padded

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _check_rows(pos: np.ndarray, width: int, rows: int) -> None:
        """Every row of a batched dispatch writes ``width`` K/V rows from
        its position: all of them must lie inside the ``rows``-row cache.
        An advanced-index write past the end raises on the CPU and
        faults on the card, so this refuses on the host first."""
        if int(pos.min()) < 0 or int(pos.max()) + width > rows:
            raise RuntimeError(
                f"K/V write of {width} rows at positions {pos.tolist()} "
                f"leaves the {rows}-row cache")

    def _run_prefill(self, ids: List[int], adapter: Optional[str],
                     temperature: float, top_k: int, bias: torch.Tensor):
        """Bucket/pad the prompt and prefill it (with the adapter's
        folded weights, or only the suffix over a cached prefix), then
        sample the first token under the slot's [V] bias row."""
        use_cache = self._prefix_cache is not None and adapter is None
        hit = self._match_prefix(ids) if use_cache else None
        if hit is not None and hit[2] + self._bucket_len(
                len(ids) - hit[2]) > self.config.max_seq:
            hit = None  # the suffix chunk must fit beside the prefix
        if hit is None:
            if use_cache:
                with self._lock:
                    self.prefix_misses += 1
            lora = self._adapter_prefill.get(adapter) if adapter else None
            logits, ks, vs = llama_prefill(
                self.params, self._tensor(self._pad_bucket(ids)),
                self.config.model, lora=lora)
            last_logits = logits[0, len(ids) - 1]
        else:
            with self._lock:
                self.prefix_hits += 1
            logits, ks, vs = self._suffix_prefill(ids, *hit)
            last_logits = logits[0, len(ids) - hit[2] - 1]
        self._step_counter += 1
        token = sample_tokens(
            last_logits[None, :],
            torch.full((1,), float(temperature), device=self.device),
            torch.full((1,), int(top_k), dtype=torch.int64,
                       device=self.device),
            self._gen, self._max_k, bias[None, :])
        if use_cache:
            self._store_prefix(ids, ks, vs)
        return ks, vs, int(token[0])

    def _suffix_prefill(self, ids: List[int], cks, cvs, plen_p: int):
        """Score the prompt's suffix at the end of a cached prefix: the
        cached K/V padded or cut to the bucket, then ONE
        llama_verify_step over the suffix chunk.

        The base is a FRESH tensor: the verify step writes the chunk into
        it in place, and a view of the LRU entry would corrupt that entry
        for every later hit. Base rows past the match may hold another
        prompt's K/V (the entry is copied whole); they never leak because
        every row at or above plen_p is rewritten, by this chunk or a
        later decode, before it is attended."""
        suffix = ids[plen_p:]
        chunk_len = self._bucket_len(len(suffix))
        bucket = self._bucket_len(plen_p + chunk_len)
        shape = (cks.shape[0], 1, bucket) + tuple(cks.shape[3:])
        keep = min(cks.shape[2], bucket)
        bases = []
        for cached in (cks, cvs):
            base = torch.zeros(shape, dtype=cached.dtype, device=self.device)
            base[:, :, :keep] = cached[:, :, :keep]
            bases.append(base)
        chunk = np.zeros((1, chunk_len), dtype=np.int64)
        chunk[0, : len(suffix)] = suffix
        start = np.asarray([plen_p], dtype=np.int64)
        self._check_rows(start, chunk_len, bucket)
        return llama_verify_step(self.params, self._tensor(chunk),
                                 bases[0], bases[1], self._tensor(start),
                                 self.config.model)

    # -- prefix caching ---------------------------------------------------
    def _match_prefix(self, ids: List[int]):
        """Longest COMMON prefix between ``ids`` and any cached prompt ->
        (ks, vs, length) or None. Causal attention makes any prefix of a
        cached block valid on its own, so prompts that share only a
        system prompt hit. Capped at len(ids)-1, so one suffix token is
        left to give the first token's logits. Under the lock: the scan
        must not race _store_prefix's insert and evict."""
        ids_arr = np.asarray(ids, dtype=np.int64)
        best_key, best_l = None, 0
        with self._lock:
            for key, (key_arr, _ks, _vs) in self._prefix_cache.items():
                n = min(len(key_arr), len(ids_arr))
                neq = np.nonzero(key_arr[:n] != ids_arr[:n])[0]
                length = min(int(neq[0]) if neq.size else n, len(ids) - 1)
                if length > best_l:
                    best_key, best_l = key, length
            if best_key is None or \
                    best_l < self.config.prefix_cache_min_tokens:
                return None
            self._prefix_cache.move_to_end(best_key)
            _key_arr, ks, vs = self._prefix_cache[best_key]
            return ks, vs, best_l

    def _store_prefix(self, ids: List[int], ks, vs) -> None:
        """Keep a prompt's K/V ([L, 1, bucket, KVH, HD]). ``ks`` and
        ``vs`` are the prefill's own tensors, never views of the engine
        cache (the insert copies them there)."""
        key = tuple(ids)
        if len(key) < self.config.prefix_cache_min_tokens:
            return
        with self._lock:
            if key in self._prefix_cache:
                return
            self._prefix_cache[key] = (np.asarray(ids, dtype=np.int64),
                                       ks, vs)
            while len(self._prefix_cache) > \
                    self.config.prefix_cache_entries:
                self._prefix_cache.popitem(last=False)

    @staticmethod
    def _insert(cache_k, cache_v, ks: torch.Tensor, vs: torch.Tensor,
                slot: int) -> None:
        """Write a batch-1 prefill's K/V ([L, 1, bucket, KVH, HD]) into
        the slot, in place (the reference donates the cache instead)."""
        bucket = ks.shape[2]
        cache_k[:, slot, :bucket] = ks[:, 0]
        cache_v[:, slot, :bucket] = vs[:, 0]

    def _draft_prefill_slot(self, ids: List[int], slot_index: int) -> None:
        """Prefill the DRAFT model's cache for a newly admitted prompt,
        so that its proposals condition on the real prefix."""
        _logits, ks, vs = llama_prefill(
            self.draft_params, self._tensor(self._pad_bucket(ids)),
            self.config.draft_model)
        self._insert(self.draft_cache_k, self.draft_cache_v, ks, vs,
                     slot_index)

    def _admit(self) -> None:
        """Prefill waiting requests into free slots."""
        while True:
            with self._lock:
                if not self.waiting:
                    return
                free = self._free_slots()
                if not free:
                    return
                request = self.waiting.pop(0)
                slot = free[0]
                slot.request = request
            ids = request.prompt_ids
            self._install_bias(request, slot.index)
            if self.config.chunked_prefill_tokens > 0 and \
                    request.adapter is None:
                # chunked admission: no blocking prefill; step() feeds
                # the prompt one chunk at a time. Every chunk write stays
                # inside the cache because add_request cut the prompt to
                # _pos_limit = max_seq-1-scratch with scratch >= C.
                # Adapter requests have no chunk path and take the
                # blocking prefill below.
                slot.prefilling = True
                slot.prefill_ids = list(ids)
                slot.prefill_pos = 0
                slot.pos = 0
                slot.next_token = 0
                continue
            ks, vs, token = self._run_prefill(
                ids, request.adapter, request.temperature, request.top_k,
                self._bias[slot.index])
            self._insert(self.cache_k, self.cache_v, ks, vs, slot.index)
            if self._spec:
                self._draft_prefill_slot(ids, slot.index)
                slot.draft_ready = True
            slot.next_token = token
            slot.pos = len(ids)
            self._emit(slot, slot.next_token)

    def _emit(self, slot: _Slot, token: int) -> None:
        request = slot.request
        if request.done:
            # cancelled from another thread mid-step: discard the
            # token and release the slot
            slot.request = None
            return
        request.output_ids.append(token)
        self.total_generated += 1
        if token in request.stop_ids:
            request.finish("stop")
        elif len(request.output_ids) >= request.max_tokens:
            request.finish("length")
        elif slot.pos >= self._pos_limit:
            request.finish("length")
        request.push_stream(token)
        if request.done:
            request.push_stream(None)
            slot.request = None

    def _gather_batch(self, active, pos_fill: int = 0):
        """Host-side per-slot inputs of a batched dispatch, ONE copy for
        the dense, multi-step, speculative and chunk paths, so a new
        per-request field cannot desync them. ``pos_fill`` is where idle
        slots park their K/V writes."""
        n = self.config.max_batch
        tokens = np.zeros(n, dtype=np.int64)
        pos = np.full(n, pos_fill, dtype=np.int64)
        temp = np.zeros(n, dtype=np.float32)
        topk = np.zeros(n, dtype=np.int64)
        lora_idx = np.zeros(n, dtype=np.int64)
        for slot in active:
            request = slot.request
            tokens[slot.index] = slot.next_token
            pos[slot.index] = slot.pos
            temp[slot.index] = request.temperature
            topk[slot.index] = request.top_k
            lora_idx[slot.index] = self._adapter_index(request)
        return tokens, pos, temp, topk, lora_idx

    def _draft_propose(self, tokens: torch.Tensor,
                       pos: torch.Tensor) -> torch.Tensor:
        """G-1 greedy draft proposals per row -> [G-1, B] on the device.

        It runs G (not G-1) draft steps: the last step's OUTPUT is
        discarded, but it writes d_{G-1}'s K/V into the draft cache. On
        full acceptance the next round starts at pos+G, and without that
        row the draft would attend a junk row from then on, silently
        collapsing acceptance exactly where acceptance is high."""
        drafts = []
        tok = tokens
        for i in range(self.config.spec_tokens):
            logits, _, _ = llama_decode_step(
                self.draft_params, tok, self.draft_cache_k,
                self.draft_cache_v, pos + i, self.config.draft_model)
            tok = torch.argmax(logits, dim=-1)
            drafts.append(tok)
        return torch.stack(drafts[:-1])

    def _spec_step(self, active) -> int:
        """One speculation round: G draft decodes + ONE target verify of
        the [B, G] chunk. Each greedy slot emits its accepted drafts and
        the target's correction (1..G tokens, each exactly what greedy
        target-only decoding gives); each sampled slot emits one token
        sampled from the target's first-position logits."""
        G = self.config.spec_tokens
        tokens, pos, temp, topk, _lora = self._gather_batch(
            active, pos_fill=self.config.max_seq - G)
        self._check_rows(pos, G, self.config.max_seq)
        tokens_t, pos_t = self._tensor(tokens), self._tensor(pos)
        drafts = self._draft_propose(tokens_t, pos_t)            # [G-1, B]
        chunk = torch.cat([tokens_t[:, None], drafts.T], dim=1)  # [B, G]
        self._step_counter += 1
        logits, _, _ = llama_verify_step(self.params, chunk, self.cache_k,
                                         self.cache_v, pos_t,
                                         self.config.model)
        greedy = torch.argmax(logits + self._bias[:, None, :], dim=-1)
        first = sample_tokens(logits[:, 0], self._tensor(temp),
                              self._tensor(topk), self._gen, self._max_k,
                              self._bias)
        # one crossing to the host: [B, G] greedy, [B] sampled, drafts
        out = torch.cat([greedy, first[:, None], chunk[:, 1:]],
                        dim=1).cpu().numpy()
        for slot in active:
            row = out[slot.index]
            if slot.request.temperature > 0.0:
                emitted = [int(row[G])]
            else:
                drafts_b, greedy_b = row[G + 1:], row[:G]
                m = 0  # accepted drafts
                while m < G - 1 and drafts_b[m] == greedy_b[m]:
                    m += 1
                self.spec_proposed += G - 1
                self.spec_accepted += m
                emitted = [int(t) for t in greedy_b[:m + 1]]
            for token in emitted:
                slot.pos += 1
                slot.next_token = token
                self._emit(slot, token)
                if slot.request is None:  # finished mid-chunk
                    break
        return len(active)

    def _multi_step(self, active, K: int) -> int:
        """K decode steps with one crossing to the host: each step's
        sampled [B] ids stay on the device and feed the next step at
        pos+i; the [K, B] ids come back once. Tokens past a stop or
        max_tokens finish are discarded on the host, so greedy outputs
        equal single-step decoding."""
        tokens, pos, temp, topk, lora_idx = self._gather_batch(
            active, pos_fill=self.config.max_seq - K)
        self._check_rows(pos, K, self.config.max_seq)
        tok, pos_t = self._tensor(tokens), self._tensor(pos)
        temp_t, topk_t = self._tensor(temp), self._tensor(topk)
        lora_idx_t = self._tensor(lora_idx)
        bank = self.lora_bank
        self._step_counter += 1
        toks = []
        for i in range(K):
            logits, _, _ = llama_decode_step(
                self.params, tok, self.cache_k, self.cache_v, pos_t + i,
                self.config.model, lora_bank=bank, lora_idx=lora_idx_t)
            tok = sample_tokens(logits, temp_t, topk_t, self._gen,
                                self._max_k, self._bias)
            toks.append(tok)
        toks = torch.stack(toks).cpu().numpy()                   # [K, B]
        for slot in active:
            for k in range(K):
                slot.pos += 1
                slot.next_token = int(toks[k, slot.index])
                self._emit(slot, slot.next_token)
                if slot.request is None:  # finished mid-burst: the
                    break                 # later tokens are discarded
        return len(active)

    def _prefill_chunk_step(self, prefilling, decoding) -> None:
        """ONE llama_verify_step advances every prefilling slot by a
        C-token chunk AND decodes every (non-LoRA) decoding slot by one
        token: a decode is a chunk whose first token is real. Fused, a
        long prompt joining costs the decoding slots one chunk forward
        per step instead of a second dispatch."""
        C = self.config.chunked_prefill_tokens
        n = self.config.max_batch
        # sampling fields from the shared gather; the chunk overlays its
        # own tokens and positions
        tokens, pos, temp, topk, _lora = self._gather_batch(
            prefilling + decoding, pos_fill=self.config.max_seq - C)
        chunk = np.zeros((n, C), dtype=np.int64)
        chunk[:, 0] = tokens
        last_idx = np.zeros(n, dtype=np.int64)
        for slot in prefilling:
            part = slot.prefill_ids[slot.prefill_pos: slot.prefill_pos + C]
            chunk[slot.index] = 0
            chunk[slot.index, : len(part)] = part
            pos[slot.index] = slot.prefill_pos
            last_idx[slot.index] = len(part) - 1
        self._check_rows(pos, C, self.config.max_seq)
        self._step_counter += 1
        logits, _, _ = llama_verify_step(
            self.params, self._tensor(chunk), self.cache_k, self.cache_v,
            self._tensor(pos), self.config.model)
        rows = torch.arange(n, device=self.device)
        sel = logits[rows, self._tensor(last_idx)]               # [B, V]
        tok = sample_tokens(sel, self._tensor(temp), self._tensor(topk),
                            self._gen, self._max_k,
                            self._bias).cpu().numpy()
        for slot in prefilling:
            slot.prefill_pos = min(slot.prefill_pos + C,
                                   len(slot.prefill_ids))
            if slot.prefill_pos >= len(slot.prefill_ids):
                slot.prefilling = False
                slot.pos = len(slot.prefill_ids)
                slot.prefill_ids = None
                slot.next_token = int(tok[slot.index])
                self._emit(slot, slot.next_token)
        for slot in decoding:
            slot.pos += 1
            slot.next_token = int(tok[slot.index])
            self._emit(slot, slot.next_token)

    def _dense_step(self, active) -> int:
        """One decode step for every active slot; only the [B] sampled
        ids cross to the host."""
        tokens, pos, temp, topk, lora_idx = self._gather_batch(
            active, pos_fill=self._dense_park)
        self._check_rows(pos, 1, self.config.max_seq)
        tokens_t, pos_t = self._tensor(tokens), self._tensor(pos)
        self._step_counter += 1
        logits, _, _ = llama_decode_step(
            self.params, tokens_t, self.cache_k, self.cache_v, pos_t,
            self.config.model, lora_bank=self.lora_bank,
            lora_idx=self._tensor(lora_idx))
        if self._spec:
            # keep the draft cache in step through dense rounds, or the
            # next speculation round would attend gaps
            llama_decode_step(self.draft_params, tokens_t,
                              self.draft_cache_k, self.draft_cache_v,
                              pos_t, self.config.draft_model)
        sampled = sample_tokens(logits, self._tensor(temp),
                                self._tensor(topk), self._gen, self._max_k,
                                self._bias).cpu().numpy()
        for slot in active:
            slot.pos += 1
            slot.next_token = int(sampled[slot.index])
            self._emit(slot, slot.next_token)
        return len(active)

    def step(self) -> int:
        """Admit, then one batched dispatch: a mixed prefill-chunk and
        decode step while prompts are being chunked, else a speculation
        round, a multi-step burst or one dense decode step. Sampling
        runs on the device. Returns the number of slots served."""
        self._admit()
        max_seq = self.config.max_seq
        handled = 0
        active = [s for s in self.slots if s.request is not None]
        prefilling = [s for s in active if s.prefilling]
        if prefilling:
            # mixed batch: prefill chunks and 1-token decodes in one
            # dispatch; adapter decodes have no chunk path and take the
            # dense step below
            fused = [s for s in active
                     if not s.prefilling and s.request.adapter is None]
            self._prefill_chunk_step(prefilling, fused)
            handled = len(prefilling) + len(fused)
            active = [s for s in self.slots
                      if s.request is not None and not s.prefilling
                      and s.request.adapter is not None]
        if not active:
            return handled
        G = self.config.spec_tokens
        if self._spec and \
                any(s.request.temperature <= 0.0 for s in active) and \
                all(s.request.adapter is None for s in active) and \
                all(s.draft_ready for s in active) and \
                all(s.pos + G <= max_seq - 1 for s in active):
            # (all-sampled batches skip speculation: a round would pay
            # the draft steps and a G-wide verify for 1 token a slot)
            return self._spec_step(active) + handled
        K = self.config.multi_step
        if K > 1 and all(s.pos + K <= max_seq - 1 for s in active):
            return self._multi_step(active, K) + handled
        return self._dense_step(active) + handled

    # ------------------------------------------------------------------
    def generate(self, prompts_ids: List[List[int]], *,
                 max_tokens: int = 32, temperature: float = 0.0,
                 top_k: int = 0, stop_ids: tuple = ()) -> List[List[int]]:
        """Synchronous batch API: token ids in, token ids out."""
        requests = [
            self.add_request(GenerationRequest(
                prompt_ids=ids, max_tokens=max_tokens,
                temperature=temperature, top_k=top_k, stop_ids=stop_ids))
            for ids in prompts_ids]
        while any(not r.done for r in requests):
            if self.step() == 0 and any(not r.done for r in requests):
                # nothing active yet (all waiting on slots) — admit again
                time.sleep(0)
        return [r.output_ids for r in requests]

    def fail_all(self, message: str) -> None:
        """Abort every waiting and active request with an error and
        reset the KV caches (serving loops call this when a step
        raises, so that requests never hang)."""
        with self._lock:
            pending = list(self.waiting)
            self.waiting.clear()
        for request in pending:
            request.finish("error", error=message)
            request.push_stream(None)
        for slot in self.slots:
            if slot.request is not None:
                slot.request.finish("error", error=message)
                slot.request.push_stream(None)
            slot.request = None
            slot.pos = 0
            slot.next_token = 0
            slot.draft_ready = True  # the caches are reset below
            slot.prefilling = False
            slot.prefill_ids = None
            slot.prefill_pos = 0
        self.cache_k.zero_()
        self.cache_v.zero_()
        if self._spec:
            self.draft_cache_k.zero_()
            self.draft_cache_v.zero_()
        if self._prefix_cache is not None:
            with self._lock:
                self._prefix_cache.clear()

    def cancel(self, request: GenerationRequest,
               finish_reason: str = "abort") -> None:
        """Finish a request early from ANY thread. Queued requests are
        withdrawn at once; an active one is marked done and its slot is
        released by the stepper at its next emission."""
        with self._lock:
            if request.done:
                return
            try:
                self.waiting.remove(request)
            except ValueError:
                pass
            request.finish(finish_reason)
        request.push_stream(None)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "waiting": len(self.waiting),
                "active": sum(1 for s in self.slots
                              if s.request is not None),
                "prefilling": sum(1 for s in self.slots
                                  if s.request is not None
                                  and s.prefilling),
                "max_batch": self.config.max_batch,
                "total_generated": self.total_generated,
            }
            if self._prefix_cache is not None:
                out["prefix_cache_entries"] = len(self._prefix_cache)
                out["prefix_hits"] = self.prefix_hits
                out["prefix_misses"] = self.prefix_misses
            if self._spec:
                out["spec_proposed"] = self.spec_proposed
                out["spec_accepted"] = self.spec_accepted
            return out
