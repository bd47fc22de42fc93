#!/usr/bin/env bash
# Environment bootstrap (the analog of the reference's ensure_*.sh):
# builds the native host library (and, where nvcc exists, the CUDA DTW
# kernel), smoke-tests the CPU path and optionally warms the GPU
# compilation cache.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== building native host library =="
make -C native
if command -v nvcc >/dev/null 2>&1 || [ -x /usr/local/cuda/bin/nvcc ]; then
  echo "== building the CUDA DTW kernel =="
  make -C native cuda
fi

echo "== smoke test (CPU backend) =="
python - <<'EOF'
import jax
jax.config.update("jax_platforms", "cpu")
from rawalign_tpu import IndexOptions, MappingOptions, set_opt
from rawalign_tpu.config import MappingFlag
from rawalign_tpu.index import index as dindex
from rawalign_tpu.map.engine import MappingEngine
from rawalign_tpu.testing import synth

ds = synth.make_dataset(seed=1, genome_lengths=[20000], n_reads=4)
io, mo = IndexOptions(), MappingOptions()
set_opt("viral", io, mo)
mo.set_flag(MappingFlag.DTW_EVALUATE_CHAINS)
idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
eng = MappingEngine(idx, mo, batch_size=4)
res = list(eng.map_reads((r.name, r.signal) for r in ds.reads))
print(f"smoke OK: {sum(r.mapped for r in res)}/{len(res)} mapped")
EOF

if [ "${WARM_GPU_CACHE:-0}" = "1" ]; then
  echo "== warming the GPU compile cache (slow the first time) =="
  timeout 1200 python bench.py || true
fi
echo "setup complete"
