"""The OpenAI-compatible serving surface on Serve: LLMConfig,
LLMServer, MultiplexLLMServer, build_llm_deployment and build_openai_app
(port of ray_tpu/serve/llm.py).

An ``LLMServer`` owns one ``ContinuousBatchingEngine`` and a stepper
thread; concurrent requests land in the engine's waiting queue and share
its decode batches. It answers OpenAI ``completions`` and
``chat_completions`` (streaming, ``n`` choices, stop strings, logprobs,
``response_format`` and tools through guided decoding), ``embeddings``
and ``score``, routed by path in ``__call__`` as the reference's replica
is. ``build_openai_app`` deploys it (or ``MultiplexLLMServer``, for many
models routed by the request's ``model``) as Serve replicas behind the
HTTP proxy.

What differs: the constructors also take ``device=``. The builders
take ``device=None`` (the card) or ``"cpu"``: on the card each replica
asks the runtime for a share of a GPU (``num_gpus``, 1 by default),
since a worker that asks for none sees no card; with ``"cpu"`` it asks
for none and builds its engine on the CPU. The stepper thread makes the
engine's device current before it steps, because the kernels launch on
the current CUDA device, which is per thread.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import math
import queue
import re
import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch import serve
from ray_tpu_torch._device import DeviceLike, device_type, resolve_device
from ray_tpu_torch.llm.engine import (
    ContinuousBatchingEngine, EngineConfig, EngineSaturatedError,
    GenerationRequest)
from ray_tpu_torch.llm.guided import (
    json_object_constraint, json_schema_constraint, parse_tool_call,
    tool_call_constraint)
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.serve.admission import BackpressureError
from ray_tpu_torch.util import tracing


# cap on per-replica compiled guided-decoding constraints (LRU)
_MAX_CONSTRAINTS = 32


def params_blob(params) -> bytes:
    """A parameter tree as the bytes a replica receives: host copies of
    its tensors (bf16 as uint16 bits), serialized once in the driver."""
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.util.host_tensor import tree_to_host
    return serialization.dumps(tree_to_host(params))


def params_from_blob(blob: bytes, device: DeviceLike = None):
    """:func:`params_blob`'s tree, its tensors on ``device``."""
    from ray_tpu_torch.core import serialization
    from ray_tpu_torch.util.host_tensor import tree_from_host
    return tree_from_host(serialization.loads(blob), resolve_device(device))


@dataclass
class LLMConfig:
    """Reference analog: serve/llm LLMConfig (model_loading_config +
    engine_kwargs + deployment_config)."""

    model_id: str = "llama-tiny"
    engine: EngineConfig = field(default_factory=EngineConfig)
    num_replicas: int = 1
    max_ongoing_requests: int = 16
    # route by prompt-prefix affinity (KV/prefix-cache locality;
    # reference: llm/_internal/serve/routing_policies/prefix_aware/)
    prefix_routing: bool = False
    # generation defaults
    max_tokens: int = 64
    temperature: float = 0.0


def stream_text_deltas(tokenizer, request):
    """Incremental detokenization over a request's stream queue: decode
    the full output each step and emit the text delta, holding back
    while the tail is an incomplete multi-byte/multi-piece character
    (U+FFFD) so streamed text matches the non-streamed decode exactly
    (reference: vLLM output streams behind serve token streaming). The
    disaggregated decode replica streams through it."""
    out_ids: List[int] = []
    emitted = ""
    while True:
        token = request.stream_queue.get()
        if token is None:
            break
        if token in request.stop_ids:
            continue
        out_ids.append(token)
        text = tokenizer.decode(out_ids)
        if text.endswith("�"):
            continue
        delta = text[len(emitted):]
        if delta:
            emitted = text
            yield delta
    if request.error is not None:
        raise RuntimeError(request.error)
    final = tokenizer.decode(out_ids)
    if len(final) > len(emitted):
        yield final[len(emitted):]


def stream_token_deltas(tokenizer, request):
    """Incremental detokenization over a request's stream queue that
    yields exactly ONE delta per non-stop generated token — the
    contract the OpenAI SSE surface advertises ("per-token chunks"),
    and what lets a stop hit count its tokens. Streamed text matches
    the non-streamed decode exactly (reference: vLLM output streams
    behind serve token streaming). When a token lands mid-way through
    a multi-byte character the decoded tail is U+FFFD: that token
    yields ``""`` and the text catches up on a later token, via
    one-token lookahead so the final token's delta can absorb any
    held-back tail."""
    out_ids: List[int] = []
    emitted = ""
    pending = False
    while True:
        token = request.stream_queue.get()
        if token is None:
            break
        if token in request.stop_ids:
            continue
        if pending:
            text = tokenizer.decode(out_ids)
            if text.endswith("�"):
                yield ""
            else:
                delta = text[len(emitted):]
                emitted = text
                yield delta
        out_ids.append(token)
        pending = True
    if request.error is not None:
        raise RuntimeError(request.error)
    if pending:
        final = tokenizer.decode(out_ids)
        yield final[len(emitted):]


class LLMServer:
    """One engine and its stepper thread behind the OpenAI surface.

    ``params``: the port's parameter tree on ``device``, or the
    serialized blob a replica receives (the reference's ``params_blob``:
    ``params_blob(tree)``, host copies loaded onto ``device``); None
    means random weights from ``config.engine.seed``. ``device``: None
    means the current CUDA device, as for the engine. Call ``stop()``
    when done: it ends the stepper thread."""

    def __init__(self, config: LLMConfig, params=None,
                 device: DeviceLike = None):
        self.config = config
        if isinstance(params, (bytes, bytearray, memoryview)):
            params = params_from_blob(params, device)
        self.engine = ContinuousBatchingEngine(config.engine, params,
                                               device=device)
        self.tokenizer = get_tokenizer(config.engine.tokenizer)
        if self.tokenizer.vocab_size > config.engine.model.vocab_size:
            raise ValueError(
                f"tokenizer vocab ({self.tokenizer.vocab_size}) exceeds "
                f"model vocab ({config.engine.model.vocab_size}); token "
                "embedding lookups would silently clamp")
        # guided decoding: compiled constraints memoized per schema /
        # tool set (mask caches inside them warm across requests)
        self._constraint_cache: Dict[Any, Any] = {}
        self._token_strs: Optional[List[Optional[str]]] = None
        self._wake = threading.Event()
        self._stopped = False
        self._stepper = threading.Thread(target=self._step_loop,
                                         daemon=True)
        self._stepper.start()

    def stop(self) -> None:
        """Halt the stepper thread and fail in-flight requests. The
        thread is joined before the requests are failed, so that no step
        runs beside ``fail_all``'s cache reset."""
        self._stopped = True
        self._wake.set()
        if threading.current_thread() is not self._stepper:
            self._stepper.join()
        self.engine.fail_all("model evicted from replica")

    def _step_loop(self) -> None:
        # the kernels launch on the current CUDA device, which is per
        # thread: a new thread starts on device 0
        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        while not self._stopped:
            try:
                if self.engine.has_work():
                    self.engine.step()
                else:
                    self._wake.wait(0.002)
                    self._wake.clear()
            except Exception as e:  # noqa: BLE001 — keep serving
                # fail in-flight requests instead of hanging them; the
                # engine stays up for subsequent requests
                self.engine.fail_all(f"engine step failed: {e!r}")

    def _validate_sampling(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Validate/clamp client sampling params before they reach the
        shared stepper thread — a bad value raising inside step() would
        fail every in-flight request on the replica, not just this one.
        """
        out: Dict[str, Any] = {}
        max_tokens = body.get("max_tokens")
        if max_tokens is None:
            # newer OpenAI name (chat): max_completion_tokens
            max_tokens = body.get("max_completion_tokens")
        if max_tokens is not None:
            if (isinstance(max_tokens, bool)
                    or not isinstance(max_tokens, int) or max_tokens < 1):
                raise ValueError("max_tokens must be a positive integer")
            out["max_tokens"] = min(max_tokens,
                                    self.config.engine.model.max_seq_len)
        temperature = body.get("temperature")
        if temperature is not None:
            if (isinstance(temperature, bool)
                    or not isinstance(temperature, (int, float))
                    or math.isnan(float(temperature))
                    or not 0.0 <= float(temperature) <= 100.0):
                raise ValueError("temperature must be a number in [0, 100]")
            # sub-epsilon temperatures overflow the float32 logit divide
            # to inf/NaN inside the stepper; they mean "greedy" anyway
            out["temperature"] = (0.0 if float(temperature) < 1e-3
                                  else float(temperature))
        top_k = body.get("top_k", 0)
        if isinstance(top_k, bool) or not isinstance(top_k, int) or top_k < 0:
            raise ValueError("top_k must be a non-negative integer")
        # clamp to vocab: the on-device sampler clips to its static
        # top-k width anyway, but a sane bound keeps intent clear
        out["top_k"] = min(top_k, self.config.engine.model.vocab_size)
        out["adapter"] = self._resolve_adapter(body.get("model"))
        for pen in ("presence_penalty", "frequency_penalty"):
            val = body.get(pen)
            if val is None:
                continue
            if isinstance(val, bool) or not isinstance(val, (int, float)) \
                    or not math.isfinite(float(val)) \
                    or not -2.0 <= float(val) <= 2.0:
                raise ValueError(f"{pen} must be a number in [-2, 2]")
            out[pen] = float(val)
        so = body.get("stream_options")
        if so is not None:
            if not body.get("stream"):
                raise ValueError("stream_options requires stream=true")
            if not isinstance(so, dict) or not isinstance(
                    so.get("include_usage", False), bool):
                raise ValueError(
                    'stream_options must be {"include_usage": bool}')
            out["include_usage"] = bool(so.get("include_usage"))
        lp = body.get("logprobs")
        top_lp = body.get("top_logprobs")
        if lp is not None or top_lp is not None:
            if isinstance(lp, bool):
                # chat shape: logprobs: true + top_logprobs: int
                if top_lp is None:
                    top_lp = 0
                if isinstance(top_lp, bool) or \
                        not isinstance(top_lp, int) or \
                        not 0 <= top_lp <= 20:
                    raise ValueError(
                        "top_logprobs must be an integer in [0, 20]")
                if not lp and body.get("top_logprobs") is not None:
                    raise ValueError(
                        "top_logprobs requires logprobs=true")
                if lp:
                    out["logprobs"] = top_lp
            elif lp is not None:
                # completions shape: logprobs: int (0 = chosen only)
                if not isinstance(lp, int) or not 0 <= lp <= 5:
                    raise ValueError(
                        "logprobs must be an integer in [0, 5]")
                out["logprobs"] = lp
            else:
                raise ValueError("top_logprobs requires logprobs")
        lb = body.get("logit_bias")
        if lb is not None:
            if not isinstance(lb, dict):
                raise ValueError("logit_bias must be an object of "
                                 "{token_id: bias}")
            vocab = self.config.engine.model.vocab_size
            clean = {}
            for tid, val in lb.items():
                try:
                    t = int(tid)
                except (TypeError, ValueError):
                    raise ValueError(
                        f"logit_bias key {tid!r} is not a token id")
                if not 0 <= t < vocab:
                    raise ValueError(
                        f"logit_bias token id {t} outside vocab "
                        f"[0, {vocab})")
                if isinstance(val, bool) or \
                        not isinstance(val, (int, float)) or \
                        not math.isfinite(float(val)):
                    raise ValueError(
                        f"logit_bias value for {t} must be a finite "
                        "number")
                clean[t] = float(val)
            out["logit_bias"] = clean
        n = body.get("n")
        if n is not None:
            if isinstance(n, bool) or not isinstance(n, int) or \
                    not 1 <= n <= 8:
                raise ValueError("n must be an integer in [1, 8]")
            out["n"] = n
        stop = body.get("stop")
        if stop is not None:
            if isinstance(stop, str):
                stop = [stop]
            if (not isinstance(stop, list) or not stop or len(stop) > 4
                    or not all(isinstance(s, str) and s for s in stop)):
                raise ValueError("stop must be a non-empty string or "
                                 "a list of 1-4 non-empty strings")
            out["stop"] = list(stop)
        return out

    # -- guided decoding: tools / tool_choice / response_format --------
    # (the OpenAI request fields; enforcement is the grammar mask of
    # llm/guided.py in the engine's bias row)

    def _vocab_strings(self) -> List[Optional[str]]:
        if self._token_strs is None:
            self._token_strs = self.tokenizer.token_strings()
        return self._token_strs

    def _cached_constraint(self, key, build):
        # Bounded LRU: one compiled NFA + its per-state mask caches
        # per distinct schema/tool-set — unbounded retention would let
        # clients rotating unique schemas grow replica memory without
        # limit.
        cache = self._constraint_cache
        c = cache.get(key)
        if c is None:
            c = build()
            cache[key] = c
            while len(cache) > _MAX_CONSTRAINTS:
                cache.pop(next(iter(cache)))
        else:
            # re-insert = recency bump (plain dict preserves order)
            cache.pop(key)
            cache[key] = c
        return c

    def _resolve_guided(self, body: Dict[str, Any],
                        allow_tools: bool = True) -> Dict[str, Any]:
        """Validate tools/tool_choice/response_format and build the
        grammar constraint. Returns {"constraint", "kind",
        "tool_mode" (None|"auto"|"forced"), "tool_names"}."""
        tools = body.get("tools")
        tool_choice = body.get("tool_choice")
        rf = body.get("response_format")
        out: Dict[str, Any] = {"constraint": None, "kind": None,
                               "tool_mode": None, "tool_names": []}

        rf_type = None
        if rf is not None:
            if not isinstance(rf, dict) or rf.get("type") not in (
                    "text", "json_object", "json_schema"):
                raise ValueError(
                    'response_format.type must be "text", "json_object"'
                    ' or "json_schema"')
            rf_type = None if rf["type"] == "text" else rf["type"]

        if tools is not None and not allow_tools:
            raise ValueError(
                "tools are only supported on /v1/chat/completions")
        names: List[str] = []
        if tools is not None:
            if not isinstance(tools, list) or not tools:
                raise ValueError("tools must be a non-empty list")
            for t in tools:
                fn = t.get("function") if isinstance(t, dict) else None
                if (not isinstance(t, dict)
                        or t.get("type") != "function"
                        or not isinstance(fn, dict)
                        or not isinstance(fn.get("name"), str)
                        or not fn["name"]):
                    raise ValueError(
                        'each tool must be {"type": "function", '
                        '"function": {"name": ...}}')
                if fn.get("parameters") is not None and \
                        not isinstance(fn["parameters"], dict):
                    raise ValueError(
                        "tool function.parameters must be an object")
                names.append(fn["name"])
            if len(set(names)) != len(names):
                raise ValueError("duplicate tool function names")
        out["tool_names"] = names

        choice = tool_choice
        if choice is None:
            choice = "auto" if tools else "none"
        forced_name = None
        if isinstance(choice, dict):
            fn = choice.get("function")
            if choice.get("type") != "function" or \
                    not isinstance(fn, dict) or \
                    not isinstance(fn.get("name"), str):
                raise ValueError(
                    'tool_choice object must be {"type": "function", '
                    '"function": {"name": ...}}')
            forced_name = fn["name"]
            if forced_name not in names:
                raise ValueError(
                    f"tool_choice names unknown function {forced_name!r}")
        elif choice not in ("none", "auto", "required"):
            raise ValueError(
                'tool_choice must be "none", "auto", "required" or a '
                "named function object")
        if tool_choice is not None and tool_choice != "none" \
                and not tools:
            raise ValueError("tool_choice requires tools")

        eos = self.tokenizer.eos_id
        vocab = self._vocab_strings
        constrained_tools = tools is not None and (
            choice == "required" or forced_name is not None)
        if constrained_tools:
            if rf_type is not None:
                raise ValueError(
                    "response_format cannot be combined with a forced "
                    "tool_choice")
            key = ("tools", json.dumps(tools, sort_keys=True),
                   forced_name)
            out["constraint"] = self._cached_constraint(
                key, lambda: tool_call_constraint(
                    tools, vocab(), eos, forced_name=forced_name))
            out["kind"] = "tools"
            out["tool_mode"] = "forced"
            return out
        if tools is not None and choice == "auto" and rf_type is None:
            out["tool_mode"] = "auto"
        if rf_type == "json_object":
            out["constraint"] = self._cached_constraint(
                ("json_object",),
                lambda: json_object_constraint(vocab(), eos))
            out["kind"] = "json_object"
        elif rf_type == "json_schema":
            js = rf.get("json_schema")
            if not isinstance(js, dict) or \
                    not isinstance(js.get("schema"), dict):
                raise ValueError(
                    "response_format.json_schema.schema is required")
            key = ("schema", json.dumps(js["schema"], sort_keys=True))
            out["constraint"] = self._cached_constraint(
                key, lambda: json_schema_constraint(
                    js["schema"], vocab(), eos))
            out["kind"] = "json_schema"
        return out

    def _chat_prompt(self, body: Dict[str, Any],
                     messages: List[Dict[str, Any]]) -> str:
        """Render the chat template: tool definitions (when given) as
        a leading segment, then one segment per message; assistant
        tool_calls and tool results render as JSON text."""
        parts = []
        tools = body.get("tools")
        if tools:
            parts.append("<|tools|>" + json.dumps(
                tools, separators=(",", ":"), sort_keys=True))
        for m in messages:
            role = m.get("role", "user")
            if m.get("tool_calls") is not None:
                content = json.dumps(m["tool_calls"],
                                     separators=(",", ":"),
                                     sort_keys=True)
            else:
                content = self._flatten_content(m.get("content") or "")
            parts.append(f"<|{role}|>{content}")
        return "".join(parts) + "<|assistant|>"

    def _chat_message(self, guided_info: Optional[Dict[str, Any]],
                      result: Dict[str, Any]):
        """(message, finish_reason) for one chat choice: tool-call
        output parses into OpenAI tool_calls with finish_reason
        "tool_calls"; everything else is assistant content."""
        text = result["text"]
        finish = result["finish_reason"]
        if guided_info and guided_info["tool_mode"] is not None:
            parsed = parse_tool_call(text, guided_info["tool_names"])
            if parsed is not None:
                call = {
                    "id": f"call_{uuid.uuid4().hex[:24]}",
                    "type": "function",
                    "function": {
                        "name": parsed["name"],
                        "arguments": json.dumps(
                            parsed["arguments"],
                            separators=(",", ":"))}}
                return ({"role": "assistant", "content": None,
                         "tool_calls": [call]}, "tool_calls")
        return {"role": "assistant", "content": text}, finish

    # head of a grammar-shaped tool call; used to classify streams
    _TOOL_HEAD = re.compile(r'^\{"name":("(?:[^"\\]|\\.)*"),"arguments":')

    @staticmethod
    def _tool_head_prefix_ok(buf: str) -> bool:
        """Could ``buf`` still grow into a tool-call head? Decides how
        long an auto-mode stream is buffered before being classified
        as plain content."""
        probe = '{"name":"'
        if len(buf) <= len(probe):
            return probe.startswith(buf)
        if not buf.startswith(probe):
            return False
        i = len(probe)
        while i < len(buf):
            ch = buf[i]
            if ch == "\\":
                i += 2
                continue
            if ch == '"':
                break
            i += 1
        else:
            return True  # still inside the name string
        rest = buf[i + 1:]  # after the name's closing quote
        tail = ',"arguments":'
        return tail.startswith(rest) or rest.startswith(tail)

    def _stream_tool_events(self, deltas, tool_names: List[str]):
        """Classify a token stream into ("content", text) /
        ("tool_head", name) / ("tool_args", text) events. Tool-call
        argument text streams incrementally with a 1-char holdback so
        the grammar's closing wrapper brace is never emitted."""
        buf = ""
        decided = None
        sent = 0
        for delta in deltas:
            buf += delta
            if decided is None:
                m = self._TOOL_HEAD.match(buf)
                if m:
                    name = json.loads(m.group(1))
                    if not tool_names or name in tool_names:
                        decided = "tool"
                        sent = m.end()
                        yield ("tool_head", name)
                    else:
                        decided = "content"
                        yield ("content", buf)
                        continue
                elif self._tool_head_prefix_ok(buf):
                    continue
                else:
                    decided = "content"
                    yield ("content", buf)
                    continue
            if decided == "content":
                yield ("content", delta)
            else:
                avail = len(buf) - 1  # hold back the wrapper brace
                if avail > sent:
                    yield ("tool_args", buf[sent:avail])
                    sent = avail
        if decided == "tool":
            end = len(buf) - 1 if buf.endswith("}") else len(buf)
            if end > sent:
                yield ("tool_args", buf[sent:end])
        elif decided is None and buf:
            yield ("content", buf)

    def _make_request(self, prompt: str, *, max_tokens, temperature,
                      top_k, adapter, logit_bias, guided=None,
                      presence_penalty=0.0, frequency_penalty=0.0,
                      logprobs=None, stream_queue=None):
        """ONE construction + admission path for all generate
        variants (non-stream, stop-string, stream) so a new sampling
        field cannot desync them."""
        ids = self.tokenizer.encode(prompt)
        request = GenerationRequest(
            prompt_ids=ids,
            max_tokens=max_tokens or self.config.max_tokens,
            temperature=(self.config.temperature if temperature is None
                         else temperature),
            top_k=top_k,
            adapter=adapter,
            logit_bias=logit_bias,
            guided=guided,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            logprobs=logprobs,
            stop_ids=(self.tokenizer.eos_id,)
            if self.tokenizer.eos_id is not None else (),
            stream_queue=stream_queue)
        try:
            self.engine.add_request(request)
        except EngineSaturatedError as exc:
            # reject-before-enqueue: surface typed backpressure (an HTTP
            # front end answers 503 + Retry-After) instead of queueing
            # behind the batch
            retry_after = min(30.0, 0.5 + 0.1 * exc.waiting)
            raise BackpressureError(self.config.model_id, retry_after,
                                    "engine_saturated") from exc
        self._wake.set()
        if self._stopped:
            # raced an LRU eviction: stop() set _stopped before its
            # fail_all; covering a request admitted after that sweep
            self.engine.fail_all("model evicted from replica")
        return ids, request

    def _generate_n(self, prompt: str,
                    sampling: Dict[str, Any]) -> List[Dict[str, Any]]:
        """n independent samples of one prompt (OpenAI `n`). Plain
        sampled requests are admitted together and co-batch in the
        engine, waited by ONE loop — no per-choice polling threads;
        stop-string requests need a stream consumer each, so n>1 with
        stop keeps a small thread pool."""
        n = sampling.get("n", 1)
        temp = sampling.get("temperature", self.config.temperature)
        if n > 1 and temp <= 0.0:
            raise ValueError("n > 1 requires temperature > 0 (greedy "
                             "choices would all be identical)")
        kwargs = dict(
            max_tokens=sampling.get("max_tokens"),
            temperature=sampling.get("temperature"),
            top_k=sampling["top_k"],
            adapter=sampling.get("adapter"),
            logit_bias=sampling.get("logit_bias"),
            guided=sampling.get("guided"),
            presence_penalty=sampling.get("presence_penalty", 0.0),
            frequency_penalty=sampling.get("frequency_penalty", 0.0),
            logprobs=sampling.get("logprobs"),
            stop=sampling.get("stop"))
        if n == 1:
            return [self._generate(prompt, **kwargs)]
        if kwargs.get("stop"):
            with cf.ThreadPoolExecutor(max_workers=n) as pool:
                return list(pool.map(
                    lambda _: self._generate(prompt, **kwargs),
                    range(n)))
        with tracing.span("engine_generate_n", component="llm.engine",
                          tags={"model": self.config.model_id,
                                "n": str(n)}):
            admitted = [self._make_request(
                prompt, max_tokens=kwargs["max_tokens"],
                temperature=kwargs["temperature"], top_k=kwargs["top_k"],
                adapter=kwargs["adapter"],
                logit_bias=kwargs["logit_bias"],
                guided=kwargs["guided"],
                presence_penalty=kwargs["presence_penalty"],
                frequency_penalty=kwargs["frequency_penalty"],
                logprobs=kwargs["logprobs"])
                for _ in range(n)]
            for _, r in admitted:
                while not r.done:
                    r.wait_done(timeout=1.0)
        results = []
        for ids, r in admitted:
            if r.error is not None:
                raise RuntimeError(r.error)
            out_ids = [i for i in r.output_ids if i not in r.stop_ids]
            result = {
                "text": self.tokenizer.decode(out_ids),
                "prompt_tokens": len(ids),
                "completion_tokens": len(r.output_ids),
                "finish_reason": r.finish_reason,
            }
            if r.logprobs is not None:
                result["logprob_data"] = [
                    e for i, e in zip(r.output_ids, r.logprob_data)
                    if i not in r.stop_ids]
            results.append(result)
        return results

    def register_adapter(self, name: str, lora_params) -> None:
        """Serve a LoRA adapter as an additional model id (reference:
        serve/llm multi-LoRA — requests select it via `model`)."""
        self.engine.register_adapter(name, lora_params)

    def _resolve_adapter(self, model: Optional[str]) -> Optional[str]:
        """Map the request's `model` onto a registered LoRA adapter;
        the base model_id (or absent) means no adapter."""
        if model is None or model == self.config.model_id:
            return None
        if model in self.engine._adapters:
            return model
        raise ValueError(
            f"unknown model {model!r}; available: "
            f"{[self.config.model_id, *self.engine._adapters]}")

    @staticmethod
    def _flatten_content(content: Any) -> str:
        """OpenAI message content is a string or a list of typed parts;
        flatten text parts rather than interpolating a Python repr."""
        if isinstance(content, str):
            return content
        if isinstance(content, list):
            texts = []
            for part in content:
                if not isinstance(part, dict) or part.get("type") != "text":
                    raise ValueError(
                        "only text content parts are supported")
                texts.append(str(part.get("text", "")))
            return "".join(texts)
        raise ValueError("message content must be a string or a list of "
                         "content parts")

    @staticmethod
    def _invalid_request(err: ValueError) -> Dict[str, Any]:
        return {"error": {"message": str(err),
                          "type": "invalid_request_error"}}

    def _generate(self, prompt: str, *, max_tokens: Optional[int] = None,
                  temperature: Optional[float] = None,
                  top_k: int = 0,
                  adapter: Optional[str] = None,
                  logit_bias: Optional[Dict[int, float]] = None,
                  guided=None,
                  presence_penalty: float = 0.0,
                  frequency_penalty: float = 0.0,
                  logprobs: Optional[int] = None,
                  stop: Optional[List[str]] = None
                  ) -> Dict[str, Any]:
        if stop:
            return self._generate_with_stop(
                prompt, max_tokens=max_tokens, temperature=temperature,
                top_k=top_k, adapter=adapter, logit_bias=logit_bias,
                guided=guided, presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty, logprobs=logprobs,
                stop=stop)
        with tracing.span("engine_generate", component="llm.engine",
                          tags={"model": self.config.model_id}):
            ids, request = self._make_request(
                prompt, max_tokens=max_tokens, temperature=temperature,
                top_k=top_k, adapter=adapter, logit_bias=logit_bias,
                guided=guided, presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty, logprobs=logprobs)
            while not request.done:
                request.wait_done(timeout=1.0)
        if request.error is not None:
            raise RuntimeError(request.error)
        out_ids = [i for i in request.output_ids
                   if i not in request.stop_ids]
        result = {
            "text": self.tokenizer.decode(out_ids),
            "prompt_tokens": len(ids),
            "completion_tokens": len(request.output_ids),
            "finish_reason": request.finish_reason,
        }
        if request.logprobs is not None:
            result["logprob_data"] = [
                e for i, e in zip(request.output_ids,
                                  request.logprob_data)
                if i not in request.stop_ids]
        return result

    def _generate_with_stop(self, prompt: str, *,
                            max_tokens: Optional[int] = None,
                            temperature: Optional[float] = None,
                            top_k: int = 0,
                            adapter: Optional[str] = None,
                            logit_bias: Optional[Dict[int, float]] = None,
                            guided=None,
                            presence_penalty: float = 0.0,
                            frequency_penalty: float = 0.0,
                            logprobs: Optional[int] = None,
                            stop: List[str] = ()) -> Dict[str, Any]:
        """Non-streaming generation with OpenAI stop STRINGS: watch
        the decoded text incrementally and cancel the engine request
        at the first stop-sequence hit (the stop text itself is not
        returned), instead of decoding to max_tokens and truncating
        after the fact."""
        with tracing.span("engine_generate", component="llm.engine",
                          tags={"model": self.config.model_id}):
            ids, request = self._make_request(
                prompt, max_tokens=max_tokens, temperature=temperature,
                top_k=top_k, adapter=adapter, logit_bias=logit_bias,
                guided=guided, presence_penalty=presence_penalty,
                frequency_penalty=frequency_penalty, logprobs=logprobs,
                stream_queue=queue.Queue())
            text = ""
            hit = False
            # one delta per token: at a hit, ``n`` is the count of
            # tokens whose text holds the stop, whatever the stepper
            # appended before the cancel landed
            for n, delta in enumerate(
                    stream_token_deltas(self.tokenizer, request), 1):
                text += delta
                cuts = [text.find(s) for s in stop if s in text]
                if cuts:
                    text = text[:min(cuts)]
                    hit = True
                    self.engine.cancel(request, "stop")
                    break
        result = {
            "text": text,
            "prompt_tokens": len(ids),
            "completion_tokens": n if hit else len(request.output_ids),
            "finish_reason": "stop" if hit else request.finish_reason,
        }
        if request.logprobs is not None:
            kept, acc = [], []
            for i, e in zip(request.output_ids, request.logprob_data):
                if i in request.stop_ids:
                    continue
                acc.append(i)
                kept.append(e)
                if hit and len(self.tokenizer.decode(acc)) >= len(text):
                    break  # logprobs stop where the returned text does
            result["logprob_data"] = kept
        return result

    def _generate_stream(self, prompt: str, *,
                         max_tokens: Optional[int] = None,
                         temperature: Optional[float] = None,
                         top_k: int = 0,
                         adapter: Optional[str] = None,
                         logit_bias: Optional[Dict[int, float]] = None,
                         guided=None,
                         presence_penalty: float = 0.0,
                         frequency_penalty: float = 0.0,
                         logprobs: Optional[int] = None,
                         stop: Optional[List[str]] = None,
                         request_sink: Optional[Dict[str, Any]] = None):
        """Yield decoded text per emitted token (reference: vLLM output
        streams behind serve token streaming). The engine's stepper
        pushes each token onto the request's queue as it decodes.
        With ``stop`` strings, a possible stop-prefix tail is held
        back so stop text is never streamed, and the engine request
        is cancelled at the hit."""
        _ids, request = self._make_request(
            prompt, max_tokens=max_tokens, temperature=temperature,
            top_k=top_k, adapter=adapter, logit_bias=logit_bias,
            guided=guided, presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty, logprobs=logprobs,
            stream_queue=queue.Queue())
        if request_sink is not None:
            # exact usage for stream_options.include_usage: the caller
            # reads output_ids after the stream drains, or the count
            # taken at a stop hit
            request_sink["request"] = request
            request_sink["prompt_tokens"] = len(_ids)
        deltas = stream_token_deltas(self.tokenizer, request)
        if not stop:
            yield from deltas
            return
        text = ""
        emitted = 0
        holdback = max(len(s) for s in stop) - 1
        for n, delta in enumerate(deltas, 1):
            text += delta
            cuts = [text.find(s) for s in stop if s in text]
            if cuts:
                cut = min(cuts)
                if request_sink is not None:
                    # one delta per token, so n tokens hold the stop;
                    # output_ids may already hold the stepper's next
                    request_sink["completion_tokens"] = n
                if cut > emitted:
                    yield text[emitted:cut]
                self.engine.cancel(request, "stop")
                return
            safe = len(text) - holdback
            if safe > emitted:
                yield text[emitted:safe]
                emitted = safe
        if len(text) > emitted:
            yield text[emitted:]

    # -- OpenAI-compatible surface (routed by path) --------------------
    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        path = request.get("__path__", "")
        if path.endswith("/chat/completions"):
            return self.chat_completions(request)
        if path.endswith("/completions"):
            return self.completions(request)
        if path.endswith("/embeddings"):
            return self.embeddings(request)
        if path.endswith("/score"):
            return self.score(request)
        if path.endswith("/models"):
            return {"object": "list",
                    "data": [{"id": self.config.model_id,
                              "object": "model"}]}
        if path.endswith("/stats"):
            return self.engine.stats()
        return {"error": f"unknown route {path!r}"}

    def embeddings(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """OpenAI /v1/embeddings: mean-pooled final hidden states
        (reference: serve/llm embedding model support via vLLM)."""
        raw = body.get("input", "")
        if isinstance(raw, str):
            inputs = [raw]
        elif isinstance(raw, (list, tuple)):
            inputs = list(raw)
        else:
            return self._invalid_request(ValueError(
                "input must be a string or a list of strings"))
        if not inputs or not all(isinstance(t, str) and t
                                 for t in inputs):
            return self._invalid_request(ValueError(
                "input must be a non-empty string or list of them"))
        limit = self.config.engine.max_seq
        data = []
        total = 0
        for i, text in enumerate(inputs):
            ids = self.tokenizer.encode(text)
            if len(ids) > limit:
                # OpenAI returns a context-length error here; silent
                # tail-truncation would hand back an embedding of the
                # document's end labeled as the whole document
                return self._invalid_request(ValueError(
                    f"input {i} is {len(ids)} tokens; this model's "
                    f"maximum context is {limit}"))
            total += len(ids)
            vec = self.engine.embed(ids)
            data.append({"object": "embedding", "index": i,
                         "embedding": [float(x) for x in vec]})
        return {
            "object": "list",
            "model": body.get("model", self.config.model_id),
            "data": data,
            "usage": {"prompt_tokens": total, "total_tokens": total},
        }

    def _token_str(self, tid: int) -> str:
        return self.tokenizer.decode([tid])

    def _completions_logprobs(self, r: Dict[str, Any]) -> Dict[str, Any]:
        """OpenAI completions logprobs object (tokens/token_logprobs/
        top_logprobs/text_offset)."""
        data = r["logprob_data"]
        tokens, lps, tops, offsets = [], [], [], []
        off = 0
        for e in data:
            ts = self._token_str(e["id"])
            tokens.append(ts)
            lps.append(e["logprob"])
            tops.append({self._token_str(tid): lp
                         for tid, lp in e["top"]})
            offsets.append(off)
            off += len(ts)
        return {"tokens": tokens, "token_logprobs": lps,
                "top_logprobs": tops, "text_offset": offsets}

    def _chat_logprobs(self, r: Dict[str, Any]) -> Dict[str, Any]:
        """OpenAI chat logprobs object (content[].top_logprobs)."""
        content = []
        for e in r["logprob_data"]:
            ts = self._token_str(e["id"])
            content.append({
                "token": ts,
                "logprob": e["logprob"],
                "bytes": list(ts.encode()),
                "top_logprobs": [
                    {"token": self._token_str(tid), "logprob": lp,
                     "bytes": list(self._token_str(tid).encode())}
                    for tid, lp in e["top"]],
            })
        return {"content": content}

    def score(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """/v1/score: similarity of text_1 against each text_2
        (reference surface: openai_api_models.py:123 ScoreRequest via
        vLLM). Cross-encoder models are not in-tree, so the score is
        the cosine similarity of the engine's pooled embeddings —
        stated divergence; same request/response shape."""
        t1 = body.get("text_1", body.get("query"))
        t2 = body.get("text_2", body.get("documents"))
        if not isinstance(t1, str) or not t1:
            return self._invalid_request(ValueError(
                "text_1 must be a non-empty string"))
        if isinstance(t2, str):
            texts = [t2]
        elif isinstance(t2, (list, tuple)):
            texts = list(t2)
        else:
            return self._invalid_request(ValueError(
                "text_2 must be a string or a list of strings"))
        if not texts or not all(isinstance(t, str) and t for t in texts):
            return self._invalid_request(ValueError(
                "text_2 must be a non-empty string or list of them"))
        limit = self.config.engine.max_seq
        ids1 = self.tokenizer.encode(t1)
        if len(ids1) > limit:
            return self._invalid_request(ValueError(
                f"text_1 is {len(ids1)} tokens; this model's maximum "
                f"context is {limit}"))
        q = self.engine.embed(ids1)
        qn = q / max(float(np.linalg.norm(q)), 1e-12)
        total = len(ids1)
        data = []
        for i, text in enumerate(texts):
            ids = self.tokenizer.encode(text)
            if len(ids) > limit:
                return self._invalid_request(ValueError(
                    f"text_2[{i}] is {len(ids)} tokens; this model's "
                    f"maximum context is {limit}"))
            total += len(ids)
            d = self.engine.embed(ids)
            dn = d / max(float(np.linalg.norm(d)), 1e-12)
            data.append({"object": "score", "index": i,
                         "score": float(qn @ dn)})
        return {
            "object": "list",
            "model": body.get("model", self.config.model_id),
            "data": data,
            "usage": {"prompt_tokens": total, "total_tokens": total},
        }

    def completions(self, body: Dict[str, Any]) -> Dict[str, Any]:
        prompt = body.get("prompt", "")
        if not isinstance(prompt, str):
            return self._invalid_request(ValueError("prompt must be a string"))
        try:
            sampling = self._validate_sampling(body)
            # response_format works on completions too (the reference's
            # vLLM request models carry it on both surfaces); tools are
            # chat-only
            guided_info = self._resolve_guided(body, allow_tools=False)
        except ValueError as e:
            return self._invalid_request(e)
        sampling["guided"] = guided_info["constraint"]
        if body.get("stream"):
            if sampling.get("n", 1) > 1:
                return self._invalid_request(ValueError(
                    "n > 1 is not supported with stream=true"))
            if sampling.get("logprobs") is not None:
                return self._invalid_request(ValueError(
                    "logprobs are not supported with stream=true"))
            return self._stream_completions(body, prompt, sampling)
        try:
            results = self._generate_n(prompt, sampling)
        except ValueError as e:
            return self._invalid_request(e)
        result = results[0]
        choices = []
        for i, r in enumerate(results):
            choice = {"index": i, "text": r["text"],
                      "finish_reason": r["finish_reason"]}
            if r.get("logprob_data") is not None:
                choice["logprobs"] = self._completions_logprobs(r)
            choices.append(choice)
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "model": body.get("model", self.config.model_id),
            "choices": choices,
            "usage": {
                "prompt_tokens": result["prompt_tokens"],
                "completion_tokens": sum(r["completion_tokens"]
                                         for r in results),
                "total_tokens": (result["prompt_tokens"]
                                 + sum(r["completion_tokens"]
                                       for r in results)),
            },
        }

    def _stream_completions(self, body: Dict[str, Any], prompt: str,
                            sampling: Dict[str, Any]):
        """SSE generator for /v1/completions with stream=true
        (reference: OpenAI SSE chunks, serve/llm streaming responses)."""
        cmpl_id = f"cmpl-{uuid.uuid4().hex[:24]}"
        model = body.get("model", self.config.model_id)
        sink: Dict[str, Any] = {}
        for text in self._generate_stream(
                prompt, max_tokens=sampling.get("max_tokens"),
                temperature=sampling.get("temperature"),
                top_k=sampling["top_k"],
                adapter=sampling.get("adapter"),
                logit_bias=sampling.get("logit_bias"),
                guided=sampling.get("guided"),
                presence_penalty=sampling.get("presence_penalty", 0.0),
                frequency_penalty=sampling.get("frequency_penalty", 0.0),
                request_sink=sink,
                stop=sampling.get("stop")):
            chunk = {"id": cmpl_id, "object": "text_completion",
                     "model": model,
                     "choices": [{"index": 0, "text": text,
                                  "finish_reason": None}]}
            yield f"data: {json.dumps(chunk)}\n\n"
        final = {"id": cmpl_id, "object": "text_completion", "model": model,
                 "choices": [{"index": 0, "text": "",
                              "finish_reason": "stop"}]}
        yield f"data: {json.dumps(final)}\n\n"
        if sampling.get("include_usage"):
            yield self._usage_chunk(sink, cmpl_id, "text_completion",
                                    model)
        yield "data: [DONE]\n\n"

    @staticmethod
    def _usage_chunk(sink: Dict[str, Any], oid: str, obj: str,
                     model: str) -> str:
        """stream_options.include_usage: the final usage-only SSE
        chunk (choices: []) shared by both streaming endpoints."""
        pt = sink.get("prompt_tokens", 0)
        ct = sink.get("completion_tokens")
        if ct is None:
            ct = len(sink["request"].output_ids) if "request" in sink else 0
        payload = {"id": oid, "object": obj, "model": model,
                   "choices": [],
                   "usage": {"prompt_tokens": pt,
                             "completion_tokens": ct,
                             "total_tokens": pt + ct}}
        return f"data: {json.dumps(payload)}\n\n"

    def _stream_chat(self, body: Dict[str, Any], prompt: str,
                     sampling: Dict[str, Any],
                     guided_info: Optional[Dict[str, Any]] = None):
        chat_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        model = body.get("model", self.config.model_id)

        def chunk(delta, finish=None):
            payload = {"id": chat_id, "object": "chat.completion.chunk",
                       "model": model,
                       "choices": [{"index": 0, "delta": delta,
                                    "finish_reason": finish}]}
            return f"data: {json.dumps(payload)}\n\n"

        yield chunk({"role": "assistant"})
        sink: Dict[str, Any] = {}
        deltas = self._generate_stream(
            prompt, max_tokens=sampling.get("max_tokens"),
            temperature=sampling.get("temperature"),
            top_k=sampling["top_k"],
            adapter=sampling.get("adapter"),
            logit_bias=sampling.get("logit_bias"),
            guided=sampling.get("guided"),
            presence_penalty=sampling.get("presence_penalty", 0.0),
            frequency_penalty=sampling.get("frequency_penalty", 0.0),
            logprobs=sampling.get("logprobs"),
            request_sink=sink,
            stop=sampling.get("stop"))
        tools_live = guided_info and guided_info["tool_mode"] is not None
        def usage_chunk():
            if not sampling.get("include_usage"):
                return None
            return self._usage_chunk(sink, chat_id,
                                     "chat.completion.chunk", model)

        if not tools_live:
            for text in deltas:
                yield chunk({"content": text})
            yield chunk({}, finish="stop")
            uc = usage_chunk()
            if uc:
                yield uc
            yield "data: [DONE]\n\n"
            return
        # tool-call streaming (OpenAI delta.tool_calls): the first
        # event carries id + function name; argument JSON streams
        # incrementally as it decodes
        made_tool = False
        for kind, val in self._stream_tool_events(
                deltas, guided_info["tool_names"]):
            if kind == "content":
                yield chunk({"content": val})
            elif kind == "tool_head":
                made_tool = True
                yield chunk({"tool_calls": [{
                    "index": 0,
                    "id": f"call_{uuid.uuid4().hex[:24]}",
                    "type": "function",
                    "function": {"name": val, "arguments": ""}}]})
            else:
                yield chunk({"tool_calls": [{
                    "index": 0,
                    "function": {"arguments": val}}]})
        yield chunk({}, finish="tool_calls" if made_tool else "stop")
        uc = usage_chunk()
        if uc:
            yield uc
        yield "data: [DONE]\n\n"

    def chat_completions(self, body: Dict[str, Any]) -> Dict[str, Any]:
        messages = body.get("messages", [])
        if not isinstance(messages, list) or any(
                not isinstance(m, dict) for m in messages):
            return self._invalid_request(
                ValueError("messages must be a list of objects"))
        try:
            sampling = self._validate_sampling(body)
            guided_info = self._resolve_guided(body)
            prompt = self._chat_prompt(body, messages)
        except ValueError as e:
            return self._invalid_request(e)
        sampling["guided"] = guided_info["constraint"]
        if body.get("stream"):
            if sampling.get("n", 1) > 1:
                return self._invalid_request(ValueError(
                    "n > 1 is not supported with stream=true"))
            if sampling.get("logprobs") is not None:
                return self._invalid_request(ValueError(
                    "logprobs are not supported with stream=true"))
            return self._stream_chat(body, prompt, sampling, guided_info)
        try:
            results = self._generate_n(prompt, sampling)
        except ValueError as e:
            return self._invalid_request(e)
        result = results[0]
        choices = []
        for i, r in enumerate(results):
            message, finish = self._chat_message(guided_info, r)
            choice = {"index": i, "message": message,
                      "finish_reason": finish}
            if r.get("logprob_data") is not None:
                choice["logprobs"] = self._chat_logprobs(r)
            choices.append(choice)
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "model": body.get("model", self.config.model_id),
            "choices": choices,
            "usage": {
                "prompt_tokens": result["prompt_tokens"],
                "completion_tokens": sum(r["completion_tokens"]
                                         for r in results),
                "total_tokens": (result["prompt_tokens"]
                                 + sum(r["completion_tokens"]
                                       for r in results)),
            },
        }


class MultiplexLLMServer:
    """One deployment serving MANY models: requests route by the OpenAI
    ``model`` field to a per-replica LRU of resident LLMServer engines
    via @serve.multiplexed; unknown ids get a 404 model_not_found and
    per-model request/token counters feed /metrics (reference:
    serve/llm/__init__.py:178 multi-model build_openai_app +
    _internal/serve routing by model id). An evicted model's ``stop()``
    joins its stepper and fails its in-flight requests."""

    def __init__(self, configs: List[LLMConfig],
                 params_blobs: Optional[Dict[str, bytes]] = None,
                 max_models_per_replica: int = 2,
                 device: DeviceLike = None):
        from ray_tpu_torch.util import metrics as metrics_mod
        if not configs:
            raise ValueError("MultiplexLLMServer needs >= 1 LLMConfig")
        self._configs: Dict[str, LLMConfig] = {}
        for c in configs:
            if c.model_id in self._configs:
                raise ValueError(f"duplicate model_id {c.model_id!r}")
            self._configs[c.model_id] = c
        self._params = dict(params_blobs or {})
        self._device = device
        # Wire the instance's LRU size through @serve.multiplexed at
        # init time (the decorator binds max_num_models_per_replica at
        # decoration; replicas construct this class locally, so the
        # bound loader never needs to pickle).
        loader = serve.multiplexed(
            max_num_models_per_replica=max_models_per_replica)(
                MultiplexLLMServer._load_model)
        self._load = lambda mid: loader(self, mid)
        self._requests = metrics_mod.Counter(
            "ray_tpu_serve_llm_requests_total", "LLM requests by model",
            tag_keys=("model",))
        self._tokens = metrics_mod.Counter(
            "ray_tpu_serve_llm_generated_tokens_total",
            "Generated tokens by model", tag_keys=("model",))

    def _load_model(self, model_id: str) -> LLMServer:
        return LLMServer(self._configs[model_id],
                         self._params.get(model_id), device=self._device)

    def _resolve(self, body: Dict[str, Any]):
        """model id -> resident LLMServer, or a 404 error dict."""
        model = body.get("model")
        if model is None and len(self._configs) == 1:
            model = next(iter(self._configs))
        if model not in self._configs:
            return None, {
                "__status__": 404,
                "error": {
                    "message": f"model {model!r} not found; serving "
                               f"{sorted(self._configs)}",
                    "type": "invalid_request_error",
                    "code": "model_not_found"}}
        self._requests.inc(tags={"model": model})
        return self._load(model), None

    def _count_tokens(self, model: str, result_or_n) -> None:
        n = (result_or_n if isinstance(result_or_n, (int, float))
             else result_or_n.get("completion_tokens", 0))
        if n:
            self._tokens.inc(n, tags={"model": model})

    def __call__(self, request: Dict[str, Any]) -> Any:
        path = request.get("__path__", "")
        if path.endswith("/models"):
            return {"object": "list",
                    "data": [{"id": mid, "object": "model"}
                             for mid in self._configs]}
        server, err = self._resolve(request)
        if err is not None:
            return err
        out = server(request)
        # count completion tokens for non-streaming responses; the
        # streaming paths count per-chunk inside the wrapped generator
        if isinstance(out, dict):
            usage = out.get("usage") or {}
            self._count_tokens(request.get("model")
                               or server.config.model_id,
                               usage.get("completion_tokens", 0))
            return out
        if hasattr(out, "__iter__") and not isinstance(out, (str, bytes)):
            model = request.get("model") or server.config.model_id

            def counted():
                n = 0
                for chunk in out:
                    n += 1
                    yield chunk
                self._count_tokens(model, n)
            return counted()
        return out


def replica_placement(device: DeviceLike, num_gpus: Optional[float],
                      default_gpus: float = 1.0):
    """(``ray_actor_options``, the replica's ``device``) for an LLM
    replica: on the card (``device`` None or CUDA) a share of a GPU,
    ``num_gpus`` or ``default_gpus``, and the replica's own current
    card; with ``"cpu"`` no GPU and the CPU. Without a GPU in this
    process, ``device=None`` raises (the device rule)."""
    if device_type(device) == "cuda":
        gpus = default_gpus if num_gpus is None else float(num_gpus)
        if not 0.0 < gpus <= 1.0:
            raise ValueError(f"num_gpus={gpus}: an LLM replica takes a "
                             "share of one card, in (0, 1]")
        return {"num_gpus": gpus}, None
    if num_gpus:
        raise ValueError("device='cpu' replicas take no GPU share")
    return {}, "cpu"


def build_llm_deployment(config: LLMConfig, params=None,
                         name: Optional[str] = None, *,
                         device: DeviceLike = None,
                         num_gpus: Optional[float] = None):
    """An Application serving `config` (reference:
    serve/llm build_llm_deployment). ``device``/``num_gpus``: see
    :func:`replica_placement`."""
    actor_options, replica_device = replica_placement(device, num_gpus)
    blob = params_blob(params) if params is not None else None
    dep = serve.deployment(
        LLMServer,
        name=name or config.model_id,
        num_replicas=config.num_replicas,
        max_ongoing_requests=config.max_ongoing_requests,
        ray_actor_options=actor_options,
        request_router=("prefix_aware" if config.prefix_routing
                        else "pow2"))
    return dep.bind(config, blob, replica_device)


def build_openai_app(llm_configs: List[LLMConfig] = None, *,
                     config: LLMConfig = None, params=None,
                     params_by_model: Optional[Dict[str, Any]] = None,
                     name: str = "openai-llm",
                     max_models_per_replica: int = 2,
                     device: DeviceLike = None,
                     num_gpus: Optional[float] = None):
    """OpenAI-compatible app (reference: serve/llm/__init__.py:178
    build_openai_app serving many models per app with model-id routing).

    One config -> a plain LLMServer deployment (no routing layer).
    Many configs -> a MultiplexLLMServer whose replicas keep an LRU of
    resident engines and route by the request ``model`` field; unknown
    ids answer 404 model_not_found, /v1/models lists all ids, and
    per-model request/token counters land in /metrics. ``device`` and
    ``num_gpus`` place the replicas (:func:`replica_placement`).
    """
    if config is not None:
        return build_llm_deployment(config, params=params, device=device,
                                    num_gpus=num_gpus)
    configs = llm_configs or [LLMConfig()]
    if len(configs) == 1 and params_by_model is None:
        return build_llm_deployment(configs[0], params=params,
                                    device=device, num_gpus=num_gpus)
    if params is not None:
        raise ValueError(
            "multi-model apps take params_by_model={model_id: params}, "
            "not params= (which model would it apply to?)")
    actor_options, replica_device = replica_placement(device, num_gpus)
    blobs = {mid: params_blob(p)
             for mid, p in (params_by_model or {}).items()}
    dep = serve.deployment(
        MultiplexLLMServer, name=name,
        num_replicas=max(c.num_replicas for c in configs),
        max_ongoing_requests=max(c.max_ongoing_requests
                                 for c in configs),
        ray_actor_options=actor_options,
        request_router=("prefix_aware"
                        if any(c.prefix_routing for c in configs)
                        else "pow2"))
    return dep.bind(configs, blobs, max_models_per_replica,
                    replica_device)
