"""Prefill/decode disaggregation for LLM serving (port of
ray_tpu/llm/disagg.py).

Capability parity with the reference's prefill-decode disaggregated
deployments (reference: python/ray/llm/_internal/serve/deployments/ —
separate prefill and decode replica pools with KV blocks transferred
between engines). Prefill replicas run compute-bound batch-1 prefills;
decode replicas run the latency-bound continuous-batching loop; the KV
block of each admitted request moves prefill→decode through the object
plane as host tensors (``util/host_tensor.py``: bf16 as uint16 bits,
written out of band into the shared-memory store), and the decode
replica moves it onto its own device before adopting the request.

    from ray_tpu_torch.llm.disagg import build_disagg_app
    app = build_disagg_app(LLMConfig(...), num_prefill=2, num_decode=1)
    handle = serve.run(app)

On the card (``device=None``) the prefill and decode replicas each ask
for half a GPU by default, so one card holds one of each; with
``device="cpu"`` they ask for none. The router needs no device.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ray_tpu_torch import serve
from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.llm.engine import ContinuousBatchingEngine, GenerationRequest
from ray_tpu_torch.llm.tokenizer import get_tokenizer
from ray_tpu_torch.serve.llm import (
    LLMConfig, LLMServer, params_blob, params_from_blob, replica_placement,
    stream_text_deltas)
from ray_tpu_torch.util.host_tensor import HostTensor, from_host, to_host


class PrefillServer:
    """Prefill-only replica: owns model weights, runs one prefill per
    call, returns the KV block (host tensors) + first sampled token.
    Never decodes. ``params``: a tree on ``device`` or a replica's
    blob, as for :class:`LLMServer`."""

    def __init__(self, config: LLMConfig, params=None,
                 device: DeviceLike = None):
        if isinstance(params, (bytes, bytearray, memoryview)):
            params = params_from_blob(params, device)
        self.config = config
        self.engine = ContinuousBatchingEngine(config.engine, params,
                                               device=device)
        self.tokenizer = get_tokenizer(config.engine.tokenizer)
        self._constraint_cache: Dict[Any, Any] = {}
        self._token_strs = None

    # guided decoding resolution borrowed from LLMServer (same
    # validation + constraint cache, no engine stepper needed here)
    _vocab_strings = LLMServer._vocab_strings
    _cached_constraint = LLMServer._cached_constraint
    _resolve_guided = LLMServer._resolve_guided

    def prefill(self, prompt: str, *, temperature: float = 0.0,
                top_k: int = 0,
                adapter: Optional[str] = None,
                logit_bias: Optional[Dict[int, float]] = None,
                response_format: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        guided = None
        if response_format is not None:
            guided = self._resolve_guided(
                {"response_format": response_format},
                allow_tools=False)["constraint"]
        ids = self.tokenizer.encode(prompt)
        ks, vs, prompt_len, first_token = self.engine.prefill_only(
            ids, temperature=temperature, top_k=top_k, adapter=adapter,
            logit_bias=logit_bias, guided=guided)
        return {"ks": to_host(ks), "vs": to_host(vs),
                "prompt_len": prompt_len,
                "first_token": first_token, "prompt_tokens": len(ids)}


class DecodeServer(LLMServer):
    """Decode replica: the normal continuous-batching LLMServer plus
    entry points for requests whose prefill ran elsewhere."""

    @staticmethod
    def _materialize_prefill(prefill_out: Any) -> Dict[str, Any]:
        from ray_tpu_torch.core.object_ref import ObjectRef
        if isinstance(prefill_out, ObjectRef):
            # fast path: the router forwarded the prefill replica's raw
            # result ref — the KV block reads straight from the object
            # plane here, never materializing in the router
            import ray_tpu_torch
            prefill_out = ray_tpu_torch.get(prefill_out, timeout=60)
        if not isinstance(prefill_out, dict):
            # a saturated prefill replica answered with a rejection
            # sentinel; the router's slow path re-routes
            raise RuntimeError("prefill result unavailable (rejected)")
        return prefill_out

    def _adopt_prefilled(self, prefill_out: Dict[str, Any], *,
                         max_tokens: int, temperature: float,
                         top_k: int, adapter: Optional[str],
                         logit_bias: Optional[Dict[int, float]] = None,
                         response_format: Optional[Dict[str, Any]] = None,
                         stream_queue=None) -> GenerationRequest:
        guided = None
        if response_format is not None:
            # decode-side rebuild of the prefill side's constraint: the
            # engine re-walks the automaton from the start state when
            # it adopts, so only the spec (not opaque state) ships
            guided = self._resolve_guided(
                {"response_format": response_format},
                allow_tools=False)["constraint"]
        request = GenerationRequest(
            prompt_ids=[],  # KV already computed; ids not needed
            max_tokens=max_tokens,
            temperature=temperature,
            top_k=top_k,
            adapter=adapter,
            logit_bias=logit_bias,
            guided=guided,
            stream_queue=stream_queue,
            stop_ids=(self.tokenizer.eos_id,)
            if self.tokenizer.eos_id is not None else ())
        # the host block onto this replica's device, then adopted
        self.engine.add_prefilled(
            request, self._on_device(prefill_out["ks"]),
            self._on_device(prefill_out["vs"]),
            prefill_out["prompt_len"], prefill_out["first_token"])
        self._wake.set()
        return request

    def _on_device(self, block):
        """A shipped K/V block on this engine's device: host tensors
        (the port's prefill replicas) bit for bit; a numpy array (the
        reference's block) as ``add_prefilled`` takes it."""
        if isinstance(block, HostTensor):
            return from_host(block, self.engine.device)
        return block

    def decode_prefilled_stream(self, prefill_out: Any, *,
                                max_tokens: int, temperature: float = 0.0,
                                top_k: int = 0,
                                adapter: Optional[str] = None,
                                logit_bias: Optional[Dict[int, float]]
                                = None,
                                response_format: Optional[Dict[str, Any]]
                                = None):
        """Streaming disagg decode: yields text deltas as tokens land,
        then one final dict carrying finish_reason + usage (reference:
        python/ray/serve/llm streaming surface over disaggregated
        deployments). The KV handoff cost is the object-plane transfer
        inside _materialize_prefill."""
        import queue
        t_handoff0 = time.perf_counter()
        prefill_out = self._materialize_prefill(prefill_out)
        kv_handoff_s = time.perf_counter() - t_handoff0
        request = self._adopt_prefilled(
            prefill_out, max_tokens=max_tokens, temperature=temperature,
            top_k=top_k, adapter=adapter, logit_bias=logit_bias,
            response_format=response_format,
            stream_queue=queue.Queue())
        yield from stream_text_deltas(self.tokenizer, request)
        yield {
            "finish_reason": request.finish_reason,
            "kv_handoff_ms": round(1000 * kv_handoff_s, 3),
            "usage": {
                "prompt_tokens": prefill_out["prompt_tokens"],
                "completion_tokens": len(request.output_ids),
                "total_tokens": (prefill_out["prompt_tokens"]
                                 + len(request.output_ids)),
            },
        }

    def decode_prefilled(self, prefill_out: Any, *,
                         max_tokens: int, temperature: float = 0.0,
                         top_k: int = 0,
                         adapter: Optional[str] = None,
                         logit_bias: Optional[Dict[int, float]] = None,
                         response_format: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        prefill_out = self._materialize_prefill(prefill_out)
        request = self._adopt_prefilled(
            prefill_out, max_tokens=max_tokens, temperature=temperature,
            top_k=top_k, adapter=adapter, logit_bias=logit_bias,
            response_format=response_format)
        while not request.done:
            request.wait_done(timeout=1.0)
        if request.error is not None:
            raise RuntimeError(request.error)
        out_ids = [t for t in request.output_ids
                   if t not in request.stop_ids]
        return {
            "text": self.tokenizer.decode(out_ids),
            "prompt_tokens": prefill_out["prompt_tokens"],
            "completion_tokens": len(request.output_ids),
            "finish_reason": request.finish_reason,
        }


class DisaggRouter:
    """Ingress: validates, fans prefill→decode, shapes the OpenAI
    response. The prefill result (with its KV block) flows between the
    two pools as a task result through the object plane — the router
    only moves the reference."""

    def __init__(self, config: LLMConfig, prefill_handle, decode_handle):
        self.config = config
        self.prefill = prefill_handle
        self.decode = decode_handle
        # reuse LLMServer's sampling validation without building an
        # engine: bind the unbound method to this router
        self._validate = LLMServer._validate_sampling
        # guided (response_format) validation needs a vocab view
        self.tokenizer = get_tokenizer(config.engine.tokenizer)
        self._constraint_cache: Dict[Any, Any] = {}
        self._token_strs = None

    _vocab_strings = LLMServer._vocab_strings
    _cached_constraint = LLMServer._cached_constraint
    _resolve_guided = LLMServer._resolve_guided

    def _resolve_adapter(self, model):
        if model is None or model == self.config.model_id:
            return None
        raise ValueError(f"unknown model {model!r}")

    def __call__(self, request: Dict[str, Any]) -> Dict[str, Any]:
        path = request.get("__path__", "")
        if path.endswith("/chat/completions"):
            # must be checked BEFORE /completions (suffix overlap);
            # chat is not offered on the disagg surface yet
            return {"error": {
                "message": "chat completions are not supported on the "
                           "disaggregated deployment; use /v1/completions",
                "type": "invalid_request_error"}}
        if path.endswith("/completions"):
            return self.completions(request)
        if path.endswith("/models"):
            return {"object": "list",
                    "data": [{"id": self.config.model_id,
                              "object": "model"}]}
        return {"error": f"unknown route {path!r}"}

    def completions(self, body: Dict[str, Any]) -> Dict[str, Any]:
        import uuid

        prompt = body.get("prompt", "")
        if not isinstance(prompt, str):
            return {"error": {"message": "prompt must be a string",
                              "type": "invalid_request_error"}}
        try:
            sampling = self._validate(self, body)
        except ValueError as e:
            return {"error": {"message": str(e),
                              "type": "invalid_request_error"}}
        temperature = sampling.get("temperature",
                                   self.config.temperature)
        top_k = sampling["top_k"]
        if sampling.get("stop"):
            # stop STRINGS need incremental text inspection on the
            # router — not offered on the disagg surface yet; reject
            # loudly instead of silently decoding through the stop
            return {"error": {
                "message": "stop strings are not supported on the "
                           "disaggregated deployment; use stop token "
                           "ids via the engine API",
                "type": "invalid_request_error"}}
        rf = body.get("response_format")
        if rf is not None:
            # validate router-side — replica-side ValueErrors would
            # surface as opaque TaskErrors; replicas rebuild the
            # constraint from the spec against their own vocab
            try:
                self._resolve_guided({"response_format": rf},
                                     allow_tools=False)
            except ValueError as e:
                return {"error": {"message": str(e),
                                  "type": "invalid_request_error"}}
        decode_kwargs = dict(
            max_tokens=sampling.get("max_tokens", self.config.max_tokens),
            temperature=temperature, top_k=top_k,
            adapter=sampling.get("adapter"),
            logit_bias=sampling.get("logit_bias"),
            response_format=rf)
        prefill_ref = self.prefill.prefill.remote(
            prompt, temperature=temperature, top_k=top_k,
            adapter=sampling.get("adapter"),
            logit_bias=sampling.get("logit_bias"),
            response_format=rf)
        if body.get("stream"):
            return self._stream_completions(body, prefill_ref,
                                            decode_kwargs)
        try:
            # fast path: forward the raw result ref so the KV block
            # moves prefill→decode directly through the object plane
            result = self.decode.decode_prefilled.remote(
                prefill_ref._ref, **decode_kwargs).result()
        except Exception:  # noqa: BLE001 — replica exceptions surface
            # as TaskError (not RuntimeError); retry once on the slow
            # path: materialize via the handle's re-routing result(),
            # which absorbs prefill-replica rejection/restart
            prefill_out = prefill_ref.result()
            result = self.decode.decode_prefilled.remote(
                prefill_out, **decode_kwargs).result()
        return {
            "id": f"cmpl-{uuid.uuid4().hex[:24]}",
            "object": "text_completion",
            "model": body.get("model", self.config.model_id),
            "choices": [{
                "index": 0,
                "text": result["text"],
                "finish_reason": result["finish_reason"],
            }],
            "usage": {
                "prompt_tokens": result["prompt_tokens"],
                "completion_tokens": result["completion_tokens"],
                "total_tokens": (result["prompt_tokens"]
                                 + result["completion_tokens"]),
            },
        }


    def _stream_completions(self, body: Dict[str, Any], prefill_ref,
                            decode_kwargs: Dict[str, Any]):
        """SSE generator over the disaggregated path: token deltas
        stream from the decode replica through the router (reference:
        serve/llm streaming everywhere, incl. disagg deployments)."""
        import json as _json
        import uuid

        cid = f"cmpl-{uuid.uuid4().hex[:24]}"
        model = body.get("model", self.config.model_id)

        def chunks(gen):
            finish = "stop"
            usage = None
            handoff_ms = None
            for item in gen:
                if isinstance(item, dict):  # trailing usage record
                    finish = item.get("finish_reason", finish)
                    usage = item.get("usage")
                    handoff_ms = item.get("kv_handoff_ms")
                    continue
                yield {"id": cid, "object": "text_completion",
                       "model": model,
                       "choices": [{"index": 0, "text": item,
                                    "finish_reason": None}]}
            final = {"id": cid, "object": "text_completion",
                     "model": model,
                     "choices": [{"index": 0, "text": "",
                                  "finish_reason": finish}]}
            if usage is not None:
                final["usage"] = usage
            if handoff_ms is not None:
                final["kv_handoff_ms"] = handoff_ms
            yield final

        stream_handle = self.decode.options(stream=True)
        gen = stream_handle.decode_prefilled_stream.remote(
            prefill_ref._ref, **decode_kwargs)
        emitted = False
        try:
            for chunk in chunks(gen):
                emitted = True
                yield f"data: {_json.dumps(chunk)}\n\n"
        except Exception:  # noqa: BLE001 — replica rejection/restart
            if emitted:
                raise  # mid-stream failure: surface, don't restart text
            # slow path: materialize the prefill via the handle's
            # re-routing result(), then retry once
            prefill_out = prefill_ref.result()
            gen = stream_handle.decode_prefilled_stream.remote(
                prefill_out, **decode_kwargs)
            for chunk in chunks(gen):
                yield f"data: {_json.dumps(chunk)}\n\n"
        yield "data: [DONE]\n\n"


def build_disagg_app(config: LLMConfig, *, params=None,
                     num_prefill: int = 1, num_decode: int = 1,
                     device: DeviceLike = None,
                     num_gpus: Optional[float] = None):
    """A prefill/decode-disaggregated OpenAI app. ``device`` and
    ``num_gpus`` place the prefill and decode replicas
    (``serve.llm.replica_placement``; half a card each by default)."""
    actor_options, replica_device = replica_placement(
        device, num_gpus, default_gpus=0.5)
    blob = params_blob(params) if params is not None else None
    prefill_dep = serve.deployment(
        PrefillServer, name=f"{config.model_id}-prefill",
        num_replicas=num_prefill,
        max_ongoing_requests=config.max_ongoing_requests,
        ray_actor_options=actor_options)
    decode_dep = serve.deployment(
        DecodeServer, name=f"{config.model_id}-decode",
        num_replicas=num_decode,
        max_ongoing_requests=config.max_ongoing_requests,
        ray_actor_options=actor_options)
    router_dep = serve.deployment(
        DisaggRouter, name=f"{config.model_id}-router",
        num_replicas=1,
        max_ongoing_requests=4 * config.max_ongoing_requests)
    return router_dep.bind(config,
                           prefill_dep.bind(config, blob, replica_device),
                           decode_dep.bind(config, blob, replica_device))
