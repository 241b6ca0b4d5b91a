"""Worker process for tests/test_multihost.py.

Usage: python tests/mh_worker.py <process_id> <num_processes> <port> <outdir>

Joins a gloo-backed multi-process CPU runtime (2 virtual chips per process),
renders a Cornell frame on the GLOBAL mesh, and checks it bitwise against
the single-device render computed locally. Also runs one sharded
inverse-rendering train step on the global mesh and round-trips a per-host
film-tile checkpoint. Writes a JSON verdict for the parent test.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), sys.argv[4])

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

# same persistent compile cache as tests/conftest.py (workers are fresh
# processes, so without it every spawn recompiles the shard_map programs)
from kytpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.1)

from kytpu.dist import multihost  # noqa: E402

multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=nproc, process_id=pid,
                     local_devices=2, platform="cpu")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from kytpu.scene import builders  # noqa: E402
from kytpu.integrator import path as kpath  # noqa: E402
from kytpu.integrator.render import render  # noqa: E402
from kytpu.diff.inverse import make_train_step, render_once  # noqa: E402

res = {"process": pid, "global_devices": len(jax.devices()),
       "local_devices": jax.local_device_count()}

scene = builders.cornell_box(width=16, height=8)
cfg = kpath.PathConfig(max_depth=2, variant="iteration", strategy="both_mis")
mesh = multihost.global_mesh(shape=(len(jax.devices()) // 2, 2))

# 1) multi-process sharded render == local single-device render, bitwise.
# Both sides accumulate 2 samples per pass so the f32 reduction association
# is identical — ((s0+s1)+(s2+s3)) — leaving RNG/transport as the only
# possible source of difference (gloo's 2-way psum is order-insensitive:
# IEEE addition of two operands is commutative).
img_mh = multihost.render_multihost(scene, mesh, spp=4, seed=5, cfg=cfg,
                                    clamp=False, samples_per_chunk=2)
npix = 16 * 8
img_local = np.asarray(render(scene, spp=4, seed=5, cfg=cfg, clamp=False,
                              rays_per_pass=2 * npix))
res["render_bitwise"] = bool(np.array_equal(img_mh, img_local))
res["render_maxdiff"] = float(np.abs(img_mh - img_local).max())
if pid == 0:
    # the parent compares the reassembled film-tile checkpoint against
    # this bitwise-verified single-device render
    np.save(os.path.join(outdir, "img_local.npy"), img_local)

# 2) sharded train step on the global mesh: finite loss, identical across
# processes (replicated params -> every host holds the same bytes)
target = jax.lax.stop_gradient(render_once(scene, jax.random.key(7),
                                           spp=2, cfg=cfg))
step, params, opt_state = make_train_step(scene, target, spp=4, cfg=cfg,
                                          mesh=mesh)
params, opt_state, loss = step(params, opt_state, jax.random.key(0))
jax.block_until_ready(params)
res["loss"] = float(np.asarray(jax.device_get(
    loss.addressable_shards[0].data)))
res["loss_finite"] = bool(np.isfinite(res["loss"]))
res["params_sample"] = {
    k: np.asarray(v.addressable_shards[0].data).ravel()[:4].tolist()
    for k, v in sorted(params.items())}

# 3) per-host film-tile checkpoint: each process writes only its own tiles;
# reassembly (done by the parent across both files) must equal the render
flat = multihost.put_sharded(
    img_mh.reshape(-1, 3), mesh, P("tile"))
ckpt = os.path.join(outdir, "film")
multihost.save_film_tiles(ckpt, flat, step=1,
                          total_rows=img_mh.reshape(-1, 3).shape[0])
res["ckpt"] = ckpt

with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
    json.dump(res, f)
print(f"worker {pid}: ok {res['render_bitwise']}")
