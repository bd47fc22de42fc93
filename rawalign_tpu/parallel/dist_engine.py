"""The distributed mapping engine: the FULL per-chunk step under a mesh.

The reference's entire parallel story is one shared-memory thread pool
(kt_for over reads + kt_pipeline, src/kthread.c:30-159). This engine is
its multi-chip replacement: the same continuous-batching MappingEngine,
with every device stage jitted over a 2-axis ``jax.sharding.Mesh``:

  stage 1 (events + sketch + index lookup) — reads are sharded over the
      FLATTENED (data, shard) axes (pure read-level data parallelism for
      the event/sketch scans), and seed lookups use **all-to-all seed
      routing** over the 'shard' axis: the sorted key table is
      partitioned into contiguous hash ranges (one per shard column);
      each device masks its seeds per owner range and a single
      ``lax.all_to_all`` delivers every hash to the owner, which answers
      with (global_lo, count) into the global position table; a second
      all_to_all routes the answers back. Index VALUES never cross the
      wire (and never leave the host): per-seed hit lists are expanded
      on the host from (global_lo, count), exactly like the
      single-device engine — so the distributed engine is PAF-identical
      by construction.

  chaining DP — per-read independent; sharded over the flattened mesh.

  DTW tile evaluation — the tile axis of every size-class batch is
      sharded over all devices; the reference signal pool is replicated
      so the indexed panel gather happens on the owning device
      (tiles.dtw_submit_indexed(mesh=...)).

Decisions, primary-chain selection, MAPQ and PAF emission stay on the
host (process 0), identical to the single-device engine.

Communication volume per round: 2 all_to_alls of (S, b_loc, NS) int32
grids (seed hashes out, (lo, count) back) — no psum over full
(B, NS, max_occ) hit tensors (SURVEY §5's all-to-all north star, vs the
replicate-reads+psum of parallel.mesh.build_mapping_step).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from rawalign_tpu.config import MappingOptions
from rawalign_tpu.index.index import RawIndex
from rawalign_tpu.map import stage1_codec, tiles
from rawalign_tpu.map.engine import MappingEngine
from rawalign_tpu.parallel import mesh as pmesh
from rawalign_tpu.seeds import sketch as dsketch
from rawalign_tpu.signal import events as devents


def mesh_layouts(n_devices: int) -> list[tuple[int, int]]:
    """The (data, shard) mesh layouts a check over ``n_devices`` covers:
    all data-parallel, a 2-wide shard axis where it fits, all sharded."""
    out = [(n_devices, 1)]
    if n_devices % 2 == 0 and n_devices >= 4:
        out.append((n_devices // 2, 2))
    if n_devices > 1:
        out.append((1, n_devices))
    return out


class DistributedMappingEngine(MappingEngine):
    """MappingEngine with every device stage sharded over ``mesh``.

    mesh must have axis names ("data", "shard"); batch_size is rounded
    up to a multiple of mesh.size so the read axis shards evenly.
    """

    def __init__(
        self,
        index: RawIndex,
        opt: MappingOptions,
        mesh: Mesh,
        **kw,
    ):
        assert tuple(mesh.axis_names) == ("data", "shard"), mesh.axis_names
        self.mesh = mesh
        n_dev = mesh.size
        bs = kw.pop("batch_size", 64)
        kw["batch_size"] = -(-bs // n_dev) * n_dev
        # the distributed stage1 is the all-to-all routed (unfused)
        # variant; chain DP runs as its own sharded dispatch (the host-C
        # chain path would serialize the mesh's reads on one host core)
        kw["fused"] = False
        kw["chain_impl"] = "device"
        # stage1 placement: 'hybrid' (default when the native lib is
        # built) detects events in host C — in a multi-host job each
        # host detects its own read shard's events before the sharded
        # dispatch — giving the distributed engine the same golden
        # C-double event parity as the single-chip default; 'device'
        # keeps the f32 detector inside the shard_map. 'host' is a
        # single-chip mode and is rejected by the routed build below.
        s1 = kw.get("stage1_impl", "auto")
        if s1 == "auto":
            from rawalign_tpu import native as _nat

            s1 = (
                "hybrid"
                if (_nat.available() and _nat.events_available())
                else "device"
            )
        if s1 not in ("device", "hybrid"):
            raise ValueError(
                f"distributed stage1_impl must be device|hybrid: {s1}"
            )
        kw["stage1_impl"] = s1
        super().__init__(index, opt, **kw)
        # the sharded DTW path assembles a replicated event pool on the
        # host, so events stay host-side in distributed mode; the stage1
        # download carries event values only in device-detector mode
        self._events_on_host = True
        self._s1_dl_events = s1 == "device"
        # replicate the resident reference signal pool over the mesh
        self._ref_cat_dev = jax.device_put(
            self._ref_cat_host, NamedSharding(mesh, P(None))
        )
        self._build_stage1_routed()
        self._build_chain_sharded()

    # ------------------------------------------------------------------
    def _build_stage1_routed(self) -> None:
        io = self.index.opt
        opt = self.opt
        ne = opt.max_events_per_chunk
        max_occ = self.max_occ
        ns_out = self._ns_out
        mesh = self.mesh
        S = mesh.shape["shard"]
        keys_sh, n_real, offsets, cut_starts = pmesh.shard_keys_for_routing(
            np.asarray(self.index.keys), S
        )
        cut_starts_j = jnp.asarray(cut_starts)  # replicated closure const
        DEAD = jnp.uint32(0xFFFFFFFF)

        hybrid = self._stage1_hybrid

        def step(packed_in, ksh, nr, off):
            if hybrid:
                # packed_in (b_loc, ne+2): host-C-detected events
                # (values | n_events | n_dropped) — this host's read
                # shard; golden C-double parity like the single-chip
                # hybrid stage1
                ev_values = packed_in[:, :ne]
                ev_n = packed_in[:, ne].astype(jnp.int32)
                ev_nd = packed_in[:, ne + 1].astype(jnp.int32)
            else:
                # packed_in (b_loc, L+1) — raw signal; f32 detector
                chunks = packed_in[:, :-1]
                lengths = packed_in[:, -1].astype(jnp.int32)
                ev = devents.detect_events_batch(
                    chunks,
                    lengths,
                    w1=opt.window_length1,
                    w2=opt.window_length2,
                    threshold1=opt.threshold1,
                    threshold2=opt.threshold2,
                    peak_height=opt.peak_height,
                    max_events=ne,
                )
                ev_values, ev_n, ev_nd = ev.values, ev.n_events, ev.n_dropped
            if io.w:
                seeds = dsketch.sketch_events_min_batch(
                    ev_values, ev_n, w=io.w, e=io.e, q=io.q, lq=io.lq
                )
            else:
                seeds = dsketch.sketch_events_batch(
                    ev_values, ev_n, e=io.e, q=io.q, lq=io.lq
                )
            # device-side seed compaction BEFORE routing (identical to
            # the single-device stage1: permutation sort keeps original
            # order) — the all_to_all grids shrink from NE to ns_out
            h0 = seeds.hashes  # (b_loc, NE) uint32
            b_loc, NE_ = h0.shape
            flag = (~seeds.valid).astype(jnp.int32)
            idx0 = jnp.broadcast_to(
                jnp.arange(NE_, dtype=jnp.int32)[None, :], (b_loc, NE_)
            )
            _f, perm = jax.lax.sort((flag, idx0), dimension=1, num_keys=1)
            perm_c = perm[:, :ns_out]
            h = jnp.take_along_axis(h0, perm_c, axis=1)
            qp_c = jnp.take_along_axis(
                seeds.qpos.astype(jnp.int32), perm_c, axis=1
            )
            v_c = jnp.take_along_axis(seeds.valid, perm_c, axis=1)
            n_valid = jnp.sum(seeds.valid, axis=1).astype(jnp.int32)
            n_compact_dropped = jnp.maximum(n_valid - ns_out, 0)
            NS = ns_out
            # owner shard of every hash (cut_starts is globally sorted)
            owner = jnp.clip(
                jnp.searchsorted(
                    cut_starts_j, h.reshape(-1), side="right"
                ).astype(jnp.int32)
                - 1,
                0,
                S - 1,
            ).reshape(h.shape)
            # all-to-all OUT: one masked (b_loc, NS) hash grid per owner
            dest = jax.lax.broadcasted_iota(jnp.int32, (S, b_loc, NS), 0)
            routed = jnp.where(
                (owner[None] == dest) & v_c[None], h[None], DEAD
            )
            routed = jax.lax.all_to_all(
                routed, "shard", split_axis=0, concat_axis=0
            )
            # owner-side lookup over the local contiguous key range; hi
            # is clipped to the real key count so padding (and DEAD
            # markers) never produce hits
            my_keys = ksh[0]
            flat = routed.reshape(-1)
            lo = jnp.searchsorted(my_keys, flat, side="left").astype(
                jnp.int32
            )
            hi = jnp.searchsorted(my_keys, flat, side="right").astype(
                jnp.int32
            )
            hi = jnp.minimum(hi, nr[0])
            cnt = jnp.maximum(hi - lo, 0).reshape(S, b_loc, NS)
            glo = (lo + off[0]).reshape(S, b_loc, NS)  # GLOBAL table index
            # all-to-all BACK: answers return to the seed's home device;
            # select the owner's slab per seed
            back = jax.lax.all_to_all(
                jnp.stack([glo, cnt], axis=1),
                "shard",
                split_axis=0,
                concat_axis=0,
            )
            glo_b = jnp.take_along_axis(back[:, 0], owner[None], axis=0)[0]
            cnt_b = jnp.take_along_axis(back[:, 1], owner[None], axis=0)[0]
            # occurrence-cap policy identical to the single-device stage
            over = cnt_b > max_occ
            n_occ_dropped = jnp.sum(
                jnp.where(v_c & over, cnt_b, 0), axis=1
            ).astype(jnp.int32)
            cnt_c = jnp.where(v_c & ~over, cnt_b, 0)
            lo_c = glo_b.astype(jnp.int32)
            # the SAME packed layout as the single-device stage1 (the
            # inherited host unpack consumes it) — shared codec, single
            # source of truth (stage1_codec.py)
            qc_c = stage1_codec.pack_qc(qp_c, cnt_c)
            # shared hits-first column permutation (stage1_codec): keeps
            # the unpacked blocks bit-identical to the single-device
            # stage1 (tests/test_stage1_codec.py cross-engine bar)
            perm2 = stage1_codec.hits_first_perm(cnt_c)
            lo_c = jnp.take_along_axis(lo_c, perm2, axis=1)
            qc_c = jnp.take_along_axis(qc_c, perm2, axis=1)
            scalars = jnp.stack(
                [
                    ev_n.astype(jnp.int32),
                    ev_nd.astype(jnp.int32),
                    n_occ_dropped,
                    n_compact_dropped.astype(jnp.int32),
                ],
                axis=1,
            )
            return stage1_codec.pack_stage1(
                ev_values, lo_c, qc_c, scalars, include_events=not hybrid
            )

        f = jax.jit(
            jax.shard_map(
                step,
                mesh=mesh,
                in_specs=(
                    P(("data", "shard"), None),
                    P("shard", None),
                    P("shard"),
                    P("shard"),
                ),
                out_specs=P(("data", "shard"), None),
                check_vma=False,
            )
        )
        ksh_d = jax.device_put(keys_sh, NamedSharding(mesh, P("shard", None)))
        nr_d = jax.device_put(n_real, NamedSharding(mesh, P("shard")))
        off_d = jax.device_put(offsets, NamedSharding(mesh, P("shard")))
        # same call shape as the single-device stage1; events stay on
        # the host in distributed mode, so the history buffer passes
        # through untouched. The base _round_gen dispatches hybrid
        # rounds through _stage1_hy, so the routed step overrides
        # whichever entry matches its input layout.
        routed = lambda packed_in, hist, hist_off: (
            f(packed_in, ksh_d, nr_d, off_d),
            hist,
        )
        if hybrid:
            self._stage1_hy = routed
        else:
            self._stage1 = routed
        # the routed stage1 shares the hits-first invariant (above), but
        # distributed mode keeps events on the host, so the prefix
        # download path never engages here (events ride the full fetch)

    # ------------------------------------------------------------------
    def _build_chain_sharded(self) -> None:
        mesh = self.mesh
        chain_fn = self._chain_fn

        def local(packed):
            A = (packed.shape[1] - 1) // 3
            dp = chain_fn(
                packed[:, :A],
                packed[:, A : 2 * A],
                packed[:, 2 * A : 3 * A],
                packed[:, 3 * A],
            )
            return jnp.concatenate(
                [
                    dp.scores.astype(jnp.float32),
                    jax.lax.bitcast_convert_type(
                        dp.preds.astype(jnp.int32), jnp.float32
                    ),
                ],
                axis=1,
            )

        self._chain_dp = jax.jit(
            jax.shard_map(
                local,
                mesh=mesh,
                in_specs=P(("data", "shard"), None),
                out_specs=P(("data", "shard"), None),
                check_vma=False,
            )
        )

    # ------------------------------------------------------------------
    def _dtw_submit_inner(
        self, da: np.ndarray, ev_cat: np.ndarray, *, ev_dev=None, ev_fetch=None
    ):
        # distributed mode always assembles the replicated host event
        # pool (events_on_host=True), so ev_dev/ev_fetch are unused
        return tiles.dtw_submit_indexed(
            da[:, 0].astype(np.int32),
            da[:, 1].astype(np.int32),
            da[:, 2].astype(np.int32),
            da[:, 3].astype(np.int32),
            da[:, 4].astype(np.int32),
            da[:, 5].astype(np.int32),
            self._ref_cat_dev,
            ev_cat,
            self._ref_cat_host,
            device_max_n=self.dtw_device_max_n,
            device_max_b=self.dtw_device_max_b,
            mesh=self.mesh,
        )
