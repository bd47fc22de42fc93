"""Multi-chip execution: mesh, shardings, and the distributed mapping step.

The reference's only parallelism is shared-memory pthreads
(src/kthread.c; SURVEY §2 row 15). This framework scales over a
``jax.sharding.Mesh`` with two axes:

  data  — read-level data parallelism: each device maps its shard of the
          read batch (the analog of kt_for over reads, rmap.cpp:916);
  shard — index parallelism for genomes too large to replicate: the
          sorted seed table is partitioned by hash range; every device
          searches its local range for ALL reads in its data-row and the
          per-seed hit lists are combined with a psum (each hash belongs
          to exactly one shard, so masked contributions are disjoint).

Collectives are XLA's (psum over the shard axis); there is no
NCCL/MPI-style code. For small genomes use shard=1 (replicated index),
which reduces to pure data parallelism with zero communication.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rawalign_tpu.index import query as dquery
from rawalign_tpu.map import chain as dchain
from rawalign_tpu.seeds import sketch as dsketch
from rawalign_tpu.signal import events as devents


def make_mesh(n_data: int, n_shard: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= n_data * n_shard, (
        f"need {n_data * n_shard} devices, have {len(devices)}"
    )
    devs = np.asarray(devices[: n_data * n_shard]).reshape(n_data, n_shard)
    return Mesh(devs, axis_names=("data", "shard"))


def shard_index_by_hash_range(keys, val_id, val_ps, n_shard: int):
    """Partition the sorted seed table into n_shard contiguous key ranges,
    padded to equal length. Returns (keys_sh, id_sh, ps_sh, bounds) where
    arrays have shape (n_shard, S_pad) and bounds (n_shard, 2) holds each
    shard's [lo, hi) hash range."""
    S = keys.shape[0]
    per = -(-max(S, 1) // n_shard)
    # Align shard cuts to hash-value boundaries so every hash value is
    # owned by exactly one shard (otherwise the psum combination would
    # double-count duplicates straddling a cut).
    cuts = [0]
    for s in range(1, n_shard):
        c = min(s * per, S)
        if 0 < c < S:
            c = int(np.searchsorted(keys, keys[c], side="left"))
        cuts.append(c)
    cuts.append(S)
    width = max(max(cuts[s + 1] - cuts[s] for s in range(n_shard)), 1)
    keys_sh = np.full((n_shard, width), np.uint32(0xFFFFFFFF), dtype=np.uint32)
    id_sh = np.zeros((n_shard, width), dtype=np.uint32)
    ps_sh = np.zeros((n_shard, width), dtype=np.uint32)
    bounds = np.zeros((n_shard, 2), dtype=np.uint32)
    for s in range(n_shard):
        lo, hi = cuts[s], cuts[s + 1]
        m = hi - lo
        if m > 0:
            keys_sh[s, :m] = keys[lo:hi]
            id_sh[s, :m] = val_id[lo:hi]
            ps_sh[s, :m] = val_ps[lo:hi]
            bounds[s, 0] = keys[lo]
            bounds[s, 1] = keys[hi - 1]
        else:
            bounds[s, 0] = np.uint32(0xFFFFFFFF)
            bounds[s, 1] = 0
    return keys_sh, id_sh, ps_sh, bounds


def shard_keys_for_routing(keys: np.ndarray, n_shard: int):
    """Partition ONLY the sorted key table for all-to-all seed routing
    (the index VALUES never leave the host: owners answer queries with
    (global_lo, count) into the host position arrays).

    Returns (keys_sh, n_real, offsets, cut_starts):
      keys_sh    (S, W) uint32 — contiguous key ranges, 0xFFFFFFFF-padded
      n_real     (S,)   int32  — real keys per shard (searchsorted hi is
                                 clipped to this so padding never counts)
      offsets    (S,)   int32  — global index of each shard's first key
      cut_starts (S,)   uint32 — first key VALUE per shard; the owner of
                                 hash h is searchsorted(cut_starts, h,
                                 'right')-1. Cuts are aligned to key-value
                                 boundaries so every hash has exactly one
                                 owner; empty shards inherit the next
                                 shard's start so routing skips them.
    """
    S = keys.shape[0]
    per = -(-max(S, 1) // n_shard)
    cuts = [0]
    for s in range(1, n_shard):
        c = min(s * per, S)
        if 0 < c < S:
            c = int(np.searchsorted(keys, keys[c], side="left"))
        cuts.append(c)
    cuts.append(S)
    width = max(max(cuts[s + 1] - cuts[s] for s in range(n_shard)), 1)
    keys_sh = np.full(
        (n_shard, width), np.uint32(0xFFFFFFFF), dtype=np.uint32
    )
    n_real = np.zeros(n_shard, dtype=np.int32)
    offsets = np.zeros(n_shard, dtype=np.int32)
    cut_starts = np.full(n_shard, np.uint32(0xFFFFFFFF), dtype=np.uint32)
    for s in range(n_shard):
        lo, hi = cuts[s], cuts[s + 1]
        m = hi - lo
        n_real[s] = m
        offsets[s] = lo
        if m > 0:
            keys_sh[s, :m] = keys[lo:hi]
            cut_starts[s] = keys[lo]
    for s in range(n_shard - 2, -1, -1):  # empty shards: inherit next
        if n_real[s] == 0:
            cut_starts[s] = cut_starts[s + 1]
    return keys_sh, n_real, offsets, cut_starts


def build_mapping_step(
    mesh: Mesh, *, io_opt, mo_opt, max_occ: int = 16, max_anchors: int = 1024
):
    """The full distributed per-chunk mapping step, jitted over the mesh.

    Inputs (global shapes):
      chunks  (B, L) f32   — sharded over 'data'
      lengths (B,)   i32   — sharded over 'data'
      keys_sh/id_sh/ps_sh (n_shard, S) — sharded over 'shard'
      bounds  (n_shard, 2) — sharded over 'shard'
    Outputs: event values/counts, chain scores/preds and anchor arrays,
    all sharded over 'data'.
    """
    ne = mo_opt.max_events_per_chunk

    def step(chunks, lengths, keys_sh, id_sh, ps_sh, bounds):
        ev = devents.detect_events_batch(
            chunks,
            lengths,
            w1=mo_opt.window_length1,
            w2=mo_opt.window_length2,
            threshold1=mo_opt.threshold1,
            threshold2=mo_opt.threshold2,
            peak_height=mo_opt.peak_height,
            max_events=ne,
        )
        seeds = dsketch.sketch_events_batch(
            ev.values, ev.n_events, e=io_opt.e, q=io_opt.q, lq=io_opt.lq
        )
        # local shard lookup: this device's key range only
        my_keys = keys_sh[0]
        my_id = id_sh[0]
        my_ps = ps_sh[0]
        my_lo = bounds[0, 0].astype(jnp.uint32)
        my_hi = bounds[0, 1].astype(jnp.uint32)
        hits = dquery.query_seeds(
            my_keys, my_id, my_ps, seeds.hashes, seeds.qpos, seeds.valid,
            max_occ=max_occ,
        )
        owned = (seeds.hashes >= my_lo) & (seeds.hashes <= my_hi)
        valid = hits.valid & owned[..., None]
        # combine disjoint per-shard contributions
        t_id = jax.lax.psum(jnp.where(valid, hits.t_id, 0), "shard")
        t_pos = jax.lax.psum(jnp.where(valid, hits.t_pos, 0), "shard")
        strand = jax.lax.psum(jnp.where(valid, hits.strand, 0), "shard")
        q_pos = hits.q_pos
        hit_valid = jax.lax.psum(valid.astype(jnp.int32), "shard") > 0

        # anchors: seg-major device-side stable lexsort, then cap
        B = chunks.shape[0]
        H = t_id.shape[1] * t_id.shape[2]
        seg = (t_id * 2 + strand).reshape(B, H)
        tgt = t_pos.reshape(B, H)
        qry = q_pos.reshape(B, H)
        av = hit_valid.reshape(B, H)
        seg = jnp.where(av, seg, jnp.int32(0x7FFFFFFF))
        order = jnp.lexsort((qry, tgt, seg), axis=-1)
        seg = jnp.take_along_axis(seg, order, axis=1)[:, :max_anchors]
        tgt = jnp.take_along_axis(tgt, order, axis=1)[:, :max_anchors]
        qry = jnp.take_along_axis(qry, order, axis=1)[:, :max_anchors]
        n_anchors = jnp.minimum(
            jnp.sum(av, axis=1), max_anchors
        ).astype(jnp.int32)
        dp = dchain.chain_dp_batch(
            seg,
            tgt,
            qry,
            n_anchors,
            window=64,
            e=io_opt.e,
            max_gap=mo_opt.max_gap_length,
            max_target_gap=mo_opt.max_target_gap_length,
            max_skips=mo_opt.max_num_skips,
        )
        return ev.values, ev.n_events, seg, tgt, qry, dp.scores, dp.preds

    step_sharded = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P("data", None),
            P("data"),
            P("shard", None),
            P("shard", None),
            P("shard", None),
            P("shard", None),
        ),
        out_specs=(
            P("data", None),
            P("data"),
            P("data", None),
            P("data", None),
            P("data", None),
            P("data", None),
            P("data", None),
        ),
        check_vma=False,
    )
    return jax.jit(step_sharded)
