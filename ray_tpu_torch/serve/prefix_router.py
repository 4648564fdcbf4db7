"""Prefix-aware request routing for LLM serving (port of
ray_tpu/serve/prefix_router.py).

Reference: python/ray/llm/_internal/serve/routing_policies/
prefix_aware/{prefix_aware_router.py,prefix_tree.py} —
PrefixCacheAffinityRouter extends pow-2 with a prefix tree: when
replica load is balanced, requests route to the replica with the
highest prompt-prefix match (KV/prefix-cache locality); when load is
imbalanced, plain pow-2 wins; low match rates fall back too. The tree
records prompt -> replica after each routing decision and evicts by
total stored characters.

Here the tree lives inside the driver-side router (the reference keeps
it in a dedicated actor because many proxies share it; this runtime
has one router per driver process — a stated simplification)."""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.serve.router import Router

# chunked trie: bounded depth regardless of prompt length
_CHUNK = 16
_MAX_INSERT_CHARS = 2048
# non-string sentinel key for each node's replica set: prompt chunks
# are strings, so arbitrary prompt text (even one containing the
# sentinel's repr) can never collide with it
_RIDS = ("__rids__",)


class PrefixTree:
    """Chunked character trie mapping prompt prefixes to the replicas
    that served them (reference: prefix_tree.py PrefixTreeActor, minus
    the actor wrapper)."""

    def __init__(self, eviction_threshold_chars: int = 400_000):
        self._root: Dict[str, Any] = {}
        self._lock = threading.Lock()
        self._chars = 0
        self._threshold = eviction_threshold_chars

    def insert(self, text: str, replica_id: str) -> None:
        text = text[:_MAX_INSERT_CHARS]
        with self._lock:
            if self._chars + len(text) > self._threshold:
                # Bounded memory: reset when full (the reference prunes
                # LRU leaves on a timer; a reset keeps the same bound
                # with an occasional cold tree — stated simplification)
                self._root = {}
                self._chars = 0
            node = self._root
            for i in range(0, len(text), _CHUNK):
                chunk = text[i:i + _CHUNK]
                child = node.get(chunk)
                if child is None:
                    child = {_RIDS: set()}
                    node[chunk] = child
                    self._chars += len(chunk)
                child[_RIDS].add(replica_id)
                node = child

    def match(self, text: str) -> Dict[str, int]:
        """replica id -> matched prefix chars (deepest node containing
        the replica along this text's path)."""
        out: Dict[str, int] = {}
        with self._lock:
            node = self._root
            depth = 0
            for i in range(0, len(text), _CHUNK):
                child = node.get(text[i:i + _CHUNK])
                if child is None:
                    break
                depth += len(text[i:i + _CHUNK])
                for rid in child[_RIDS]:
                    out[rid] = depth
                node = child
        return out

    def drop_replica(self, replica_id: str) -> None:
        """Forget a dead replica everywhere (its cache died with it)."""
        with self._lock:
            stack = [self._root]
            while stack:
                node = stack.pop()
                for key, child in node.items():
                    if key is _RIDS:
                        child.discard(replica_id)
                    else:
                        stack.append(child)


def extract_prompt(request: Any) -> Optional[str]:
    """Pull routable text out of an OpenAI-shaped request dict."""
    if not isinstance(request, dict):
        return None
    prompt = request.get("prompt")
    if isinstance(prompt, str) and prompt:
        return prompt
    messages = request.get("messages")
    if isinstance(messages, list) and messages:
        parts: List[str] = []
        for m in messages:
            content = m.get("content") if isinstance(m, dict) else None
            if isinstance(content, str):
                parts.append(content)
        if parts:
            return "\n".join(parts)
    return None


class PrefixAwareRouter(Router):
    """Pow-2 router + prefix-cache affinity (reference:
    prefix_aware_router.py PrefixCacheAffinityRouter):

    - balanced load + match rate >= match_rate_threshold -> the replica
      with the deepest prompt-prefix match wins (cache locality);
    - otherwise plain pow-2.
    Every routed prompt is inserted into the tree afterward."""

    imbalanced_threshold = 10     # queue-length gap = "imbalanced"
    match_rate_threshold = 0.10   # matched chars / prompt chars

    def __init__(self, deployment_name: str, controller):
        super().__init__(deployment_name, controller)
        self.tree = PrefixTree()

    def choose(self, args_blob: Optional[bytes] = None
               ) -> Tuple[str, Any]:
        """All Router paths (submit/stream/fetch + their retries) come
        through here with the serialized request."""
        text = None
        if args_blob is not None:
            from ray_tpu_torch.core import serialization
            try:
                args, _kwargs = serialization.loads(args_blob)
                if args:
                    text = extract_prompt(args[0])
            except Exception:
                pass  # unroutable request body: plain pow-2 applies
        rid, handle = self._choose_for_prompt(text)
        if text:
            self.tree.insert(text, rid)
        return rid, handle

    def _refresh(self, block: bool) -> None:
        """Replica-set changes also purge dead replicas from the tree
        (their prefix caches died with them)."""
        with self._lock:
            before = {rid for rid, _ in self._replicas}
        super()._refresh(block)
        with self._lock:
            after = {rid for rid, _ in self._replicas}
        for rid in before - after:
            self.tree.drop_replica(rid)

    def _choose_for_prompt(self, text: Optional[str]
                           ) -> Tuple[str, Any]:
        if not text:
            return super().choose()
        with self._lock:
            replicas = dict(self._replicas)
        if len(replicas) <= 1:
            return super().choose()
        matches = {rid: n for rid, n in self.tree.match(text).items()
                   if rid in replicas}
        if not matches:
            return super().choose()
        best_rid = max(matches, key=lambda r: matches[r])
        if matches[best_rid] / max(len(text), 1) \
                < self.match_rate_threshold:
            return super().choose()
        # A replica that recently rejected sits out affinity: without
        # this, a saturated cache-affine replica whose queue gap never
        # crosses imbalanced_threshold livelocks retries while the
        # rest of the fleet idles. The penalty score decays toward
        # zero, so a recovered replica regains its affinity traffic.
        if self.rejection_penalty(best_rid) >= 1.0:
            return super().choose()
        # Balance check probes ONLY best + two sampled candidates (the
        # reference pow-2 discipline): probing every replica would put
        # a dead replica's 1s probe timeout on each request.
        others = [rid for rid in replicas if rid != best_rid]
        sample = self._rng.sample(others, min(2, len(others)))
        qlens = {rid: self._queue_len(rid, replicas[rid])
                 for rid in [best_rid] + sample}
        if (qlens[best_rid] - min(qlens.values())
                > self.imbalanced_threshold):
            return super().choose()  # imbalanced: load wins over cache
        return best_rid, replicas[best_rid]
