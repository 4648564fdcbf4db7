"""Collectives for gradient sync (port of ray_tpu/parallel/collective.py):
the block codecs, the all-reduce and its two halves over a
``torch.distributed`` group, and the in-graph quantized reductions.

**The codecs.** The reference's quantized transport (EQuARX-style) cuts
a payload into blocks of ``_QUANT_BLOCK`` f32 values and sends each
block as int8 with a scale and zero point, or as fp8-e4m3 with a scale.
``_quantize`` / ``_dequantize`` do so on the tensor's own device; fp8
goes through ``torch.float8_e4m3fn`` (round to nearest even, as
``ml_dtypes``' cast) and travels as its bits in ``uint8``.
``_quantize_chunk`` / ``_dequantize_chunk`` wrap them for numpy, in the
reference's payload tuples ``("q8", n, q, scale, zp)`` /
``("f8", n, q_bits, scale)``, which they equal bit for bit.

**The collectives over a group** (:func:`allreduce`,
:func:`reduce_scatter_flat`, :func:`allgather_flat`) cut a flat payload
as the reference does (``_chunk_bounds``, ``np.array_split``'s cut).
Uncompressed they are ``dist.all_reduce``, ``reduce_scatter_tensor`` and
``all_gather_into_tensor`` (the chunks padded to one length). Compressed
(sum and mean) they run the reference's host ring: world - 1 hops of
reduce-scatter and world - 1 of all-gather, each hop's payload sent to
the next rank by P2P (``_group.Exchange``, ``batch_isend_irecv``) where
the reference posts it to its KV store. A quantized hop dequantizes,
accumulates in f32 and requantizes; each rank quantizes its reduced
chunk once, and every rank, the owner too, decodes the same wire bytes,
so the result is the same on every rank. ``ef_key`` keeps a residual
per (group, key, size) that takes every quantization error the rank
introduces and is added to the next round's input (error feedback).
Each op records the bytes it sent (uncompressed: a ring's share of the
payload) and their compression ratio
(``ray_tpu_train_collective_bytes_total``,
``ray_tpu_train_collective_compression_ratio``). The KV rendezvous, the
object plane, the tree algorithm, ``broadcast``, ``barrier`` and
``send`` / ``recv`` are ROADMAP.md Queue 1 items 4.3 and 9.

**The in-graph reductions** (:func:`quantized_psum`,
:func:`quantized_pmean`, :func:`quantized_reduce_scatter`) over a mesh
axis (``_sharded.Axis``) or a group: one shared scale per block from an
all-reduce MAX of the blocks' |max|, so every rank quantizes onto the
same grid; int8 codes summed exactly as int32 (fp8 values as f32), and
dequantized once. The ``_lockstep`` forms run the same reduction over a
list of per-shard tensors in one process (virtual ranks, possibly on
one device), as ``ring_attention_lockstep`` does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.ops.quant_matmul import scale_from_amax
from ray_tpu_torch.parallel import _group
from ray_tpu_torch.parallel._sharded import Axis, _all_gather, _reduce_scatter
from ray_tpu_torch.util import flight_recorder as _flight
from ray_tpu_torch.util import metrics as _metrics

# quantization block: scale/zero-point granularity (256 f32 = 1 KB of
# payload carries 8 B of block metadata → int8 moves ~3.9x fewer bytes)
_QUANT_BLOCK = 256

_COMPRESSIONS = ("int8", "fp8")


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------

def _block_view(flat, block: int = _QUANT_BLOCK) -> Tuple[torch.Tensor, int]:
    """A payload (tensor or array) flattened to f32, zero-padded to a
    block multiple and viewed as [nblocks, block], and its length."""
    if not isinstance(flat, torch.Tensor):
        flat = torch.from_numpy(np.ascontiguousarray(flat, dtype=np.float32))
    flat = flat.reshape(-1).float()
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block), n


def _quantize(chunk: torch.Tensor, compression: str) -> Tuple[
        torch.Tensor, ...]:
    """The wire tensors of a chunk, on its device: (int8 codes [nb, B],
    scale [nb], zero point [nb]) or (fp8 bits as uint8 [nb, B], scale
    [nb])."""
    blocks, _n = _block_view(chunk)
    if compression == "int8":
        lo = blocks.amin(dim=1, keepdim=True)
        hi = blocks.amax(dim=1, keepdim=True)
        zp = (hi + lo) * 0.5
        scale = torch.clamp((hi - lo) / 254.0, min=1e-12)
        q = torch.clamp(torch.round((blocks - zp) / scale), -127, 127).to(
            torch.int8)
        return q, scale.reshape(-1), zp.reshape(-1)
    if compression == "fp8":
        amax = blocks.abs().amax(dim=1, keepdim=True)
        scale = torch.clamp(amax / 448.0, min=1e-12)
        q = (blocks / scale).to(torch.float8_e4m3fn).view(torch.uint8)
        return q, scale.reshape(-1)
    raise ValueError(f"unknown compression {compression!r}; "
                     f"expected one of {_COMPRESSIONS}")


def _dequantize(wire: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """The f32 values [n] of :func:`_quantize`'s wire tensors."""
    if len(wire) == 3:
        q, scale, zp = wire
        out = q.float() * scale[:, None] + zp[:, None]
    else:
        q, scale = wire
        out = q.view(torch.float8_e4m3fn).float() * scale[:, None]
    return out.reshape(-1)[:n]


def _quantize_chunk(chunk: np.ndarray, compression: str) -> tuple:
    """:func:`_quantize` of a numpy chunk, as the reference's payload."""
    flat = torch.from_numpy(
        np.ascontiguousarray(chunk, dtype=np.float32).reshape(-1))
    wire = [t.numpy() for t in _quantize(flat, compression)]
    return ("q8" if compression == "int8" else "f8", flat.numel(), *wire)


def _dequantize_chunk(payload: tuple) -> np.ndarray:
    """:func:`_dequantize` of a :func:`_quantize_chunk` payload."""
    tag, n, *wire = payload
    if tag not in ("q8", "f8"):
        raise ValueError(f"unknown quantized payload tag {tag!r}")
    return _dequantize([torch.from_numpy(np.ascontiguousarray(a))
                        for a in wire], n).numpy()


def _wire_like(n: int, compression: str, device) -> List[torch.Tensor]:
    """Empty receive buffers for a quantized chunk of ``n`` values."""
    nb = -(-n // _QUANT_BLOCK)
    codes = torch.int8 if compression == "int8" else torch.uint8
    out = [torch.empty((nb, _QUANT_BLOCK), dtype=codes, device=device),
           torch.empty(nb, dtype=torch.float32, device=device)]
    if compression == "int8":
        out.append(torch.empty(nb, dtype=torch.float32, device=device))
    return out


def _nbytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---------------------------------------------------------------------------
# error feedback and transport metrics
# ---------------------------------------------------------------------------

# One persistent residual per (group, leaf key, flat size). Every
# quantization error a rank introduces (its input's quantization, each
# hop's requantization, the final all-gather's quantization) is added
# here and fed back into the same leaf's next round: the reduction is a
# sum, so compensating anywhere in it compensates globally, and the
# time-averaged result converges to the exact one.
_ef_buffers: Dict[Tuple[str, str, int], torch.Tensor] = {}


def _group_key(group) -> str:
    """The key of a group's residuals: "default" for the default group
    (or None), else the group's own name."""
    if group is None or group is dist.group.WORLD:
        return "default"
    return getattr(group, "group_name", None) or f"group-{id(group)}"


def reset_error_feedback(group=None) -> None:
    """Drop the residuals of ``group``, or of every group when None (the
    reference's ``group_name=None``; ``dist.group.WORLD`` is the default
    group's alone)."""
    if group is None:
        _ef_buffers.clear()
        return
    name = _group_key(group)
    for key in [k for k in _ef_buffers if k[0] == name]:
        del _ef_buffers[key]


def error_feedback_residual(group, ef_key: str) -> Optional[torch.Tensor]:
    """A copy of a leaf's current residual (None if never used)."""
    name = _group_key(group)
    for (g, k, _size), buf in _ef_buffers.items():
        if g == name and k == ef_key:
            return buf.clone()
    return None


def _ef_buffer(group, ef_key: str, size: int, device) -> torch.Tensor:
    key = (_group_key(group), ef_key, size)
    buf = _ef_buffers.get(key)
    if buf is None:
        buf = torch.zeros(size, dtype=torch.float32, device=device)
        _ef_buffers[key] = buf
    return buf


COLLECTIVE_BYTES = _metrics.Counter(
    "ray_tpu_train_collective_bytes_total",
    "Tensor payload bytes this rank put on the wire in collective ops",
    tag_keys=("op", "dtype"))
COLLECTIVE_COMPRESSION = _metrics.Gauge(
    "ray_tpu_train_collective_compression_ratio",
    "Uncompressed-equivalent bytes / wire bytes of the last collective",
    tag_keys=("op", "dtype"))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _note_bytes(op: str, dtype: str, wire: int, raw: int,
                t0_ns: Optional[int] = None) -> None:
    rec = _flight.RECORDER
    if rec is not None and t0_ns:
        rec.record("collective", op, t0_ns, _flight.clock_ns() - t0_ns,
                   {"dtype": dtype, "wire": int(wire),
                    "ratio": (round(raw / wire, 3) if wire > 0 else 1.0)})
    if wire <= 0:
        return
    tags = {"op": op, "dtype": dtype}
    _metrics.record_batch([
        ("counter", "ray_tpu_train_collective_bytes_total", tags,
         float(wire), None),
        ("gauge", "ray_tpu_train_collective_compression_ratio", tags,
         raw / wire, None)])


# ---------------------------------------------------------------------------
# the ring over a group
# ---------------------------------------------------------------------------

def _chunk_bounds(n: int, world: int) -> List[int]:
    """Start offsets (plus final n) of np.array_split's flat chunking."""
    base, extra = divmod(n, world)
    bounds = [0]
    for i in range(world):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return bounds


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "prod": dist.ReduceOp.PRODUCT, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


def _ring_sent(bounds: List[int], skip: int) -> int:
    """The values one half of a ring sends from a rank: every chunk but
    ``skip`` (its own in the reduce-scatter, its successor's in the
    all-gather). The uncompressed collectives count their bytes so."""
    return bounds[-1] - (bounds[skip + 1] - bounds[skip])


class _Ring:
    """One quantized collective's view of its group: rank, size, the
    chunk bounds of a flat payload, and the bytes it sent (``wire``)
    beside their f32 size (``raw``)."""

    def __init__(self, group, rank: int, world: int, bounds: List[int],
                 compression: str, device):
        self.group, self.rank, self.world = group, rank, world
        self.bounds, self.compression, self.device = bounds, compression, \
            device
        self.wire = self.raw = 0

    def size(self, i: int) -> int:
        return self.bounds[i + 1] - self.bounds[i]

    def encode(self, chunk: torch.Tensor, residual: Optional[torch.Tensor],
               offset: int) -> List[torch.Tensor]:
        """The wire tensors of an outgoing chunk; its quantization error
        (value - dequantized) lands in this rank's residual slice."""
        wire = list(_quantize(chunk, self.compression))
        if residual is not None and chunk.numel():
            residual[offset:offset + chunk.numel()] += (
                chunk - _dequantize(wire, chunk.numel()))
        return wire

    def hop(self, send: Sequence[torch.Tensor], send_n: int,
            recv_n: int) -> List[torch.Tensor]:
        """Send ``send`` (a chunk of ``send_n`` values) to the next rank
        and receive a chunk of ``recv_n`` values from the previous one;
        an empty chunk moves nothing."""
        recv = _wire_like(recv_n, self.compression, self.device)
        self.wire += _nbytes(send)
        self.raw += send_n * 4
        nxt, prv = (self.rank + 1) % self.world, (self.rank - 1) % self.world
        _group.Exchange([(t, nxt) for t in send if t.numel()],
                        [(t, prv) for t in recv if t.numel()],
                        self.group).wait()
        return recv


def _ring_reduce_scatter(ring: _Ring, flat: torch.Tensor,
                         residual: Optional[torch.Tensor]) -> torch.Tensor:
    """Quantized ring reduce-scatter (sum) over flat chunks: world - 1
    hops, each sending one chunk to the next rank (``send_idx = (rank -
    1 - s) % world``), dequantized, accumulated in f32 and requantized at
    the next hop; every quantization error is fed into ``residual``.
    Returns this rank's fully reduced chunk (exact f32, never
    requantized)."""
    rank, world, b = ring.rank, ring.world, ring.bounds
    acc = [flat[b[i]:b[i + 1]].clone() for i in range(world)]
    for s in range(world - 1):
        send_idx = (rank - 1 - s) % world
        recv_idx = (rank - 2 - s) % world
        wire = ring.encode(acc[send_idx], residual, b[send_idx])
        got = ring.hop(wire, ring.size(send_idx), ring.size(recv_idx))
        acc[recv_idx] = acc[recv_idx] + _dequantize(got, ring.size(recv_idx))
    return acc[rank]


def _ring_all_gather(ring: _Ring, own: Sequence[torch.Tensor]
                     ) -> List[List[torch.Tensor]]:
    """Ring all-gather of quantized chunks: each rank's wire tensors
    travel around the ring, forwarded verbatim at every hop (no
    requantization). Returns them indexed by owning rank."""
    rank, world = ring.rank, ring.world
    payloads: List = [None] * world
    payloads[rank] = carry = list(own)
    carry_n = ring.size(rank)
    for s in range(world - 1):
        owner = (rank - 1 - s) % world
        carry = ring.hop(carry, carry_n, ring.size(owner))
        carry_n = ring.size(owner)
        payloads[owner] = carry
    return payloads


def _check(op: str, compression: Optional[str], dtype: torch.dtype) -> None:
    if op not in _REDUCE_OPS:
        raise ValueError(f"unknown op {op!r}")
    if compression is None:
        return
    if compression not in _COMPRESSIONS:
        raise ValueError(f"unknown compression {compression!r}; "
                         f"expected one of {_COMPRESSIONS} or None")
    if op not in ("sum", "mean"):
        raise ValueError(
            f"compression={compression!r} only supports sum/mean "
            f"(dequantize-accumulate is additive), not op={op!r}")
    if not dtype.is_floating_point:
        raise ValueError(f"compression={compression!r} needs a float "
                         f"tensor, got dtype {dtype}")


def _quantized_ring(tensor: torch.Tensor, group, ef_key: Optional[str],
                    group_, rank: int, world: int, compression: str):
    """(ring, flat f32 input with the leaf's residual added, the residual
    emptied for this round's errors or None)."""
    flat = tensor.detach().reshape(-1).float()
    residual = None
    if ef_key is not None:
        residual = _ef_buffer(group, ef_key, flat.numel(), flat.device)
        flat = flat + residual
        residual.zero_()  # re-filled with this round's errors
    ring = _Ring(group_, rank, world, _chunk_bounds(flat.numel(), world),
                 compression, tensor.device)
    return ring, flat, residual


def allreduce(tensor: torch.Tensor, op: str = "sum", group=None,
              compression: Optional[str] = None,
              ef_key: Optional[str] = None) -> torch.Tensor:
    """All-reduce of ``tensor`` over ``group`` (None: the default group,
    or world 1) -> a new tensor of its shape and dtype, the same on every
    rank. ``op``: sum, mean, prod, max or min, by ``dist.all_reduce``.
    ``compression`` "int8" / "fp8" (sum and mean only) runs the quantized
    ring instead, block-quantizing every hop; ``ef_key``, a stable id of
    the tensor, keeps its error-feedback residual from round to round."""
    t0 = _flight.clock_ns() if _flight.RECORDER is not None else None
    _check(op, compression, tensor.dtype)
    group_, rank, world = _group.resolve(group, tensor.device)
    if world == 1:
        return tensor / 1 if op == "mean" else tensor.clone()
    if compression is None:
        out = tensor.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=_REDUCE_OPS[op], group=group_)
        bounds = _chunk_bounds(out.numel(), world)
        wire = raw = out.element_size() * (
            _ring_sent(bounds, rank) + _ring_sent(bounds, (rank + 1) % world))
    else:
        ring, flat, residual = _quantized_ring(tensor, group, ef_key, group_,
                                               rank, world, compression)
        own = _ring_reduce_scatter(ring, flat, residual)
        # not a send: the all-gather counts the payload when it travels
        mine = ring.encode(own, residual, ring.bounds[rank])
        out = torch.cat([_dequantize(p, ring.size(i)) for i, p in
                         enumerate(_ring_all_gather(ring, mine))])
        wire, raw = ring.wire, ring.raw
    if op == "mean":
        out = out / world
    out = out.reshape(tensor.shape).to(tensor.dtype)
    _note_bytes("allreduce", compression or _dtype_name(tensor.dtype),
                wire, raw, t0)
    return out


def _padded_chunks(flat: torch.Tensor, bounds: List[int]) -> torch.Tensor:
    """[world, longest chunk]: ``flat``'s chunks, each zero-padded to the
    first (longest) one."""
    world, width = len(bounds) - 1, bounds[1] - bounds[0]
    if flat.numel() == world * width:
        return flat.reshape(world, width)
    out = flat.new_zeros(world, width)
    for i in range(world):
        out[i, :bounds[i + 1] - bounds[i]] = flat[bounds[i]:bounds[i + 1]]
    return out


def reduce_scatter_flat(tensor: torch.Tensor, op: str = "sum", group=None,
                        compression: Optional[str] = None,
                        ef_key: Optional[str] = None
                        ) -> Tuple[torch.Tensor, int]:
    """Reduce-scatter of the flattened ``tensor`` over ``_chunk_bounds``'
    chunks -> (this rank's reduced chunk, exact f32 when compressed, and
    its flat offset): the gradient half of a ZeRO-1 step, half the bytes
    of an all-reduce. Uncompressed it is one ``reduce_scatter_tensor`` of
    the chunks padded to one length; compressed, the quantized ring."""
    t0 = _flight.clock_ns() if _flight.RECORDER is not None else None
    _check(op, compression, tensor.dtype)
    flat = tensor.detach().reshape(-1)
    group_, rank, world = _group.resolve(group, flat.device)
    if world == 1:
        out = flat.to(torch.float32 if compression else flat.dtype,
                      copy=True)
        return out, 0
    bounds = _chunk_bounds(flat.numel(), world)
    size = bounds[rank + 1] - bounds[rank]
    if compression is None:
        chunks = _padded_chunks(flat, bounds)
        own = chunks.new_empty(chunks.shape[1])
        _reduce_scatter(own, chunks.reshape(-1), op=_REDUCE_OPS[op],
                        group=group_)
        own = own[:size]
        wire = raw = flat.element_size() * _ring_sent(bounds, rank)
    else:
        ring, flat, residual = _quantized_ring(tensor, group, ef_key, group_,
                                               rank, world, compression)
        own = _ring_reduce_scatter(ring, flat, residual)
        wire, raw = ring.wire, ring.raw
    if op == "mean":
        own = own / world
    _note_bytes("reduce_scatter", compression or _dtype_name(tensor.dtype),
                wire, raw, t0)
    return own, bounds[rank]


def allgather_flat(shard: torch.Tensor, group=None,
                   total: Optional[int] = None) -> torch.Tensor:
    """All-gather of every rank's flat shard, concatenated in rank order:
    the parameter half of a ZeRO-1 step. The shards are
    ``_chunk_bounds(total, world)``'s chunks (they may differ by one);
    without ``total`` the ranks first gather their sizes. One
    ``all_gather_into_tensor`` of the shards padded to one length."""
    t0 = _flight.clock_ns() if _flight.RECORDER is not None else None
    flat = shard.detach().reshape(-1)
    group_, rank, world = _group.resolve(group, flat.device)
    if world == 1:
        return flat.clone()
    if total is None:
        sizes = torch.zeros(world, dtype=torch.int64, device=flat.device)
        mine = torch.tensor([flat.numel()], dtype=torch.int64,
                            device=flat.device)
        _all_gather(sizes, mine, group=group_)
        total = int(sizes.sum())
    bounds = _chunk_bounds(total, world)
    width = bounds[1] - bounds[0]
    if bounds[rank + 1] - bounds[rank] != flat.numel():
        raise ValueError(f"rank {rank}'s shard holds {flat.numel()} values; "
                         f"the chunk of {total} is "
                         f"{bounds[rank + 1] - bounds[rank]}")
    padded = flat
    if flat.numel() != width:
        padded = torch.cat([flat, flat.new_zeros(width - flat.numel())])
    gathered = flat.new_empty(world * width)
    _all_gather(gathered, padded.contiguous(), group=group_)
    out = gathered.reshape(world, width)
    if total != world * width:
        out = torch.cat([out[i, :bounds[i + 1] - bounds[i]]
                         for i in range(world)])
    nbytes = flat.element_size() * _ring_sent(bounds, (rank + 1) % world)
    _note_bytes("allgather", _dtype_name(flat.dtype), nbytes, nbytes, t0)
    return out.reshape(-1)


# ---------------------------------------------------------------------------
# in-graph quantized reductions over a mesh axis or a group
# ---------------------------------------------------------------------------

def _axis(axis, device) -> Tuple[object, int, int]:
    """(group, rank, size) of a ``_sharded.Axis`` or a group."""
    if isinstance(axis, Axis):
        return axis.group, axis.rank, axis.size
    return _group.resolve(axis, device)


def _check_dtype(dtype: str) -> None:
    if dtype not in _COMPRESSIONS:
        raise ValueError(f"dtype must be int8|fp8, got {dtype!r}")


def _blocks(x: torch.Tensor, block: int, error=None):
    """(x + error) in f32, zero-padded and viewed as [nb, block]."""
    flat = x.reshape(-1).float()
    if error is not None:
        flat = flat + error.reshape(-1).float()
    return _block_view(flat, block)[0]


def _codes(blocks: torch.Tensor, amax: torch.Tensor, dtype: str):
    """(scale, the values each rank puts in the sum, what it means by
    them in f32): int8 codes as int32, fp8 values dequantized."""
    if dtype == "int8":
        scale = scale_from_amax(amax, 127.0)
        q = torch.clamp(torch.round(blocks / scale), -127.0, 127.0)
        return scale, q.to(torch.int32), q * scale
    scale = scale_from_amax(amax, 448.0)
    deq = (blocks / scale).to(torch.float8_e4m3fn).float() * scale
    return scale, deq, deq


def _finish(x: torch.Tensor, out_blocks: torch.Tensor, blocks, deq_own,
            error):
    n = x.numel()
    out = out_blocks.reshape(-1)[:n].reshape(x.shape)
    if x.dtype.is_floating_point:
        out = out.to(x.dtype)
    if error is None:
        return out
    return out, (blocks - deq_own).reshape(-1)[:n].reshape(x.shape)


def quantized_psum(x: torch.Tensor, axis=None, dtype: str = "int8",
                   block: int = _QUANT_BLOCK, error=None):
    """The sum of ``x`` over ``axis`` (a ``_sharded.Axis`` or a group;
    None: the default group, or world 1) through a block-quantized
    transport with a scale shared by every rank (each block's |max|
    all-reduced MAX): int8 codes summed exactly as int32 and dequantized
    once, or fp8 values summed in f32. With ``error`` (the previous
    round's residual, x's shape) -> (sum, this round's residual), the
    error-feedback pair."""
    _check_dtype(dtype)
    group, _rank, size = _axis(axis, x.device)
    blocks = _blocks(x, block, error)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    if size > 1:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale, wire, deq_own = _codes(blocks, amax, dtype)
    acc = wire.clone()
    if size > 1:
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    out_blocks = acc.float() * scale if dtype == "int8" else acc
    return _finish(x, out_blocks, blocks, deq_own, error)


def quantized_pmean(x: torch.Tensor, axis=None, dtype: str = "int8",
                    block: int = _QUANT_BLOCK, error=None):
    """:func:`quantized_psum` / the axis's size: the DDP gradient mean."""
    size = _axis(axis, x.device)[2]
    result = quantized_psum(x, axis, dtype, block, error)
    if error is None:
        return result / size
    out, new_error = result
    return out / size, new_error


def quantized_reduce_scatter(x: torch.Tensor, axis=None,
                             dtype: str = "int8",
                             block: int = _QUANT_BLOCK) -> torch.Tensor:
    """This rank's 1/size of the sum of the flat ``x`` over ``axis``,
    through the shared-scale transport (int8 summed as int32 by
    ``reduce_scatter_tensor``, fp8 as f32): the ZeRO-1 gradient half.
    ``x.numel()`` must be a multiple of size x ``block`` (pad at the call
    site)."""
    _check_dtype(dtype)
    if x.ndim != 1:
        raise ValueError(f"expected flat 1-D input, got shape "
                         f"{tuple(x.shape)}")
    group, rank, size = _axis(axis, x.device)
    if x.numel() % (size * block):
        raise ValueError(f"x.numel()={x.numel()} must be a multiple of the "
                         f"axis size x the quant block ({size} x {block}); "
                         "pad at the call site")
    blocks = x.reshape(-1, block).float()
    amax = blocks.abs().amax(dim=1, keepdim=True)
    if size > 1:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale, wire, _deq = _codes(blocks, amax, dtype)
    rows = blocks.shape[0] // size
    shard = wire[rank * rows:(rank + 1) * rows].clone()
    if size > 1:
        _reduce_scatter(shard, wire.contiguous(), op=dist.ReduceOp.SUM,
                        group=group)
    if dtype == "int8":
        return (shard.float() * scale[rank * rows:(rank + 1) * rows]
                ).reshape(-1)
    return shard.reshape(-1)


def quantized_psum_lockstep(xs: Sequence[torch.Tensor], dtype: str = "int8",
                            block: int = _QUANT_BLOCK, errors=None):
    """:func:`quantized_psum` over virtual ranks in one process: ``xs``
    holds each shard's tensor (each on its own device, which may repeat).
    The shared scale and the sum are formed on the first shard's device,
    in shard order, and each shard gets the result on its device. With
    ``errors`` (one residual per shard) -> (sums, new residuals)."""
    _check_dtype(dtype)
    home = xs[0].device
    blocks = [_blocks(x, block, None if errors is None else e)
              for x, e in zip(xs, errors or [None] * len(xs))]
    amax = torch.stack([b.abs().amax(dim=1, keepdim=True).to(home)
                        for b in blocks]).amax(dim=0)
    coded = [_codes(b, amax.to(b.device), dtype) for b in blocks]
    acc = coded[0][1].clone()
    for _scale, wire, _deq in coded[1:]:
        acc = acc + wire.to(home)
    out_blocks = acc.float() * coded[0][0] if dtype == "int8" else acc
    outs = [_finish(x, out_blocks.to(x.device), b, c[2], e)
            for x, b, c, e in zip(xs, blocks, coded,
                                  errors or [None] * len(xs))]
    if errors is None:
        return outs
    return [o[0] for o in outs], [o[1] for o in outs]


def quantized_pmean_lockstep(xs: Sequence[torch.Tensor],
                             dtype: str = "int8",
                             block: int = _QUANT_BLOCK, errors=None):
    """:func:`quantized_psum_lockstep` / the number of shards."""
    result = quantized_psum_lockstep(xs, dtype, block, errors)
    if errors is None:
        return [r / len(xs) for r in result]
    outs, new_errors = result
    return [o / len(xs) for o in outs], new_errors
