"""Two-process jax.distributed smoke test (CPU, no GPU cluster needed).

Validates the multi-HOST path end to end on one machine:

  * ``distributed.init()`` brings up the coordinator + 2 processes,
    each with 4 virtual CPU devices (8 global);
  * a psum over the GLOBAL mesh proves cross-process collectives run;
  * each process takes its read shard (``distributed.shard_files``
    analog on read tuples), maps it with the DistributedMappingEngine
    over its local (2, 2) mesh — the production multi-host mode for
    replicated indexes: read-level data parallelism across hosts,
    all-to-all-routed sharded lookup within each host's devices
    (SURVEY §5 distributed-backend design);
  * process 0 gathers both PAF shards (via the filesystem) and asserts
    the concatenation equals a single-process run of the same reads.

Run:  python scripts/smoke_multiprocess.py
(The parent spawns the two workers and prints one JSON verdict line.)
"""

import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PROC = 2
DEV_PER_PROC = 4
PORT = 12973

_MT = re.compile(r"\tmt:f:[^\t\n]*")


def _dataset():
    from rawalign_tpu import config
    from rawalign_tpu.config import MappingFlag
    from rawalign_tpu.index import index as dindex
    from rawalign_tpu.testing import synth

    ds = synth.make_dataset(
        seed=7, genome_lengths=[12000, 6000], n_reads=12,
        read_len_bp=(150, 350),
    )
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("viral", io, mo)
    mo.set_flag(MappingFlag.DTW_EVALUATE_CHAINS)
    mo.max_events_per_chunk = 256
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    reads = [(r.name, r.signal) for r in ds.reads]
    return idx, mo, reads


def _map_lines(idx, mo, reads, mesh=None):
    from rawalign_tpu.io import paf
    from rawalign_tpu.map import engine as dengine
    from rawalign_tpu.parallel.dist_engine import DistributedMappingEngine

    if mesh is None:
        eng = dengine.MappingEngine(idx, mo, batch_size=8)
    else:
        eng = DistributedMappingEngine(idx, mo, mesh, batch_size=8)
    return sorted(
        _MT.sub("", paf.paf_line(r)) for r in eng.map_reads(iter(reads))
    )


def worker(out_dir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from rawalign_tpu.parallel import distributed, mesh as pmesh

    distributed.init()
    pid, n = distributed.process_info()
    assert n == N_PROC, (pid, n)
    assert len(jax.devices()) == N_PROC * DEV_PER_PROC

    # cross-process collective sanity: psum over ALL global devices
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    gmesh = Mesh(jax.devices(), ("d",))
    ones = jax.jit(
        jax.shard_map(
            lambda x: jax.lax.psum(x, "d"),
            mesh=gmesh, in_specs=P(), out_specs=P(),
            check_vma=False,
        )
    )(jnp.ones(()))
    # fetching a fully-replicated result is process-local
    assert float(ones) == N_PROC * DEV_PER_PROC, float(ones)

    idx, mo, reads = _dataset()
    # read-level data parallelism across processes (shard_files analog)
    mine = [r for i, r in enumerate(reads) if i % n == pid]
    # each process maps its shard over its LOCAL devices with the
    # distributed engine (replicated-index multi-host mode)
    lmesh = pmesh.make_mesh(2, 2, devices=jax.local_devices())
    lines = _map_lines(idx, mo, mine, mesh=lmesh)
    with open(os.path.join(out_dir, f"shard_{pid}.paf"), "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def main() -> int:
    if os.environ.get("SMOKE_WORKER"):
        worker(os.environ["SMOKE_OUT"])
        return 0

    out_dir = tempfile.mkdtemp(prefix="rawalign_smoke_")
    procs = []
    for pid in range(N_PROC):
        env = dict(
            os.environ,
            SMOKE_WORKER="1",
            SMOKE_OUT=out_dir,
            JAX_COORDINATOR_ADDRESS=f"localhost:{PORT}",
            JAX_NUM_PROCESSES=str(N_PROC),
            JAX_PROCESS_ID=str(pid),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={DEV_PER_PROC}"
            ).strip(),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
        )
    fail = False
    for pid, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            fail = True
        if p.returncode != 0:
            fail = True
            sys.stderr.write(f"worker {pid} failed:\n{err[-3000:]}\n")
    if fail:
        print(json.dumps({"metric": "multiprocess_smoke", "ok": False}))
        return 1

    shards = []
    for pid in range(N_PROC):
        with open(os.path.join(out_dir, f"shard_{pid}.paf")) as f:
            shards += [ln for ln in f.read().splitlines() if ln]
    # single-process baseline on the full read set
    import jax

    jax.config.update("jax_platforms", "cpu")
    idx, mo, reads = _dataset()
    want = _map_lines(idx, mo, reads)
    ok = sorted(shards) == want
    print(
        json.dumps(
            {
                "metric": "multiprocess_smoke",
                "ok": ok,
                "processes": N_PROC,
                "devices_per_process": DEV_PER_PROC,
                "reads": len(want),
            }
        )
    )
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
