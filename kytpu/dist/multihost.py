"""Multi-host (multi-process) distribution: bootstrap, render, film tiles.

This is the process-level half of the story that replaces the reference's
single parallel boundary — the OpenMP row loop fork (ky.cpp:3696-3701) —
at pod scale. `kytpu.dist.shard` turns that loop into an SPMD shard_map
over a ("tile", "spp") device mesh; this module boots N OS processes into
one JAX runtime (`jax.distributed.initialize`) so the same SPMD program
runs unchanged across hosts:

  - every process contributes its local chips to one GLOBAL device mesh;
  - film pixels are sharded over "tile" so each host only ever touches its
    own strip (tiles never cross DCN during rendering);
  - samples are sharded over "spp"; the one psum per pass rides ICI;
  - gradients of replicated scene parameters arrive via the shard_map
    transpose's psum — identical program, any number of hosts.

Because each lane's RNG stream depends only on (seed, sample_id, pixel_id),
the multi-process render is bitwise identical to the single-process and
single-device renders (asserted by tests/test_multihost.py, which spawns
real OS processes on the CPU backend with gloo collectives).

Host-side assembly uses explicit per-shard callbacks
(`jax.make_array_from_callback` / addressable_shards) rather than implicit
global-array ops, so nothing here assumes single-process addressability.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kytpu.dist import mesh as kmesh
from kytpu.dist import shard as kshard


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_devices: int | None = None,
               platform: str | None = None) -> None:
    """Join (or create) a multi-process JAX runtime.

    On managed clusters the three Nones let JAX discover everything from
    the environment; on a bare host pass them explicitly. For CPU-backend testing /
    development, pass them explicitly and set `platform="cpu"` with
    `local_devices=k` to expose k virtual chips per process over gloo
    collectives. Must run before any other JAX use in the process.
    """
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        if local_devices:
            jax.config.update("jax_num_cpu_devices", local_devices)
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def process_index() -> int:
    return jax.process_index()


def process_count() -> int:
    return jax.process_count()


def global_mesh(shape: tuple[int, int] | None = None,
                spp: int | None = None) -> Mesh:
    """("tile", "spp") mesh over ALL global devices (every process's chips).

    Devices are laid out so that each process's local chips are contiguous
    along the "tile" axis when shape[0] is a multiple of the process count:
    film tiles then stay host-local and assembly never crosses hosts.
    """
    return kmesh.make_mesh(jax.devices(), shape=shape, spp=spp)


def put_sharded(np_arr, mesh: Mesh, spec: P):
    """Place a host-replicated numpy array onto a (possibly multi-process)
    mesh sharding. Every process must pass the same values."""
    arr = np.asarray(np_arr)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def all_gather_host(arr) -> np.ndarray:
    """Assemble a (possibly non-fully-addressable) sharded array into a full
    numpy array on EVERY host. One collective; outside-jit."""
    from jax.experimental import multihost_utils
    if arr.is_fully_addressable:
        return np.asarray(arr)
    return np.asarray(multihost_utils.process_allgather(arr, tiled=True))


def accumulate_tiles(scene, mesh: Mesh, spp_range: tuple[int, int],
                     seed: int = 1234, cfg=None, mode: str = "path",
                     aov: str | None = None,
                     samples_per_chunk: int | None = None, accum=None):
    """UNNORMALIZED film accumulation over sample ids [s0, s1) on a global
    mesh -> flat (npad, 3) array sharded P("tile").

    Each lane's radiance depends only on (seed, sample_id, pixel_id), so
    the accumulation can stop at any sample boundary, be checkpointed with
    save_film_tiles, and resume ON A DIFFERENT TOPOLOGY (the
    utils/checkpoint.py contract): pass load_film_tiles' reassembled rows
    as `accum` together with a NEW mesh and the remaining sample range —
    the final film is identical to the uninterrupted render as long as the
    per-chunk sample association (samples_per_chunk) matches. Rows of
    `accum` beyond the new mesh's padded length are dropped (padding lanes
    re-render pixel 0.. and are sliced away at normalization).
    """
    from kytpu.integrator import path as kpath

    cfg = cfg or kpath.PathConfig()
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    n_tile = mesh.shape["tile"]
    n_spp = mesh.shape["spp"]
    s0, s1 = spp_range
    if (s1 - s0) % n_spp:
        raise ValueError(f"sample count {s1 - s0} not divisible by "
                         f"spp-axis size {n_spp}")

    npad = kshard._pad_to(npix, n_tile)
    pid_np = (np.arange(npad, dtype=np.int64) % npix).astype(np.int32)
    px = put_sharded((pid_np % w).astype(np.float32), mesh, P("tile"))
    py = put_sharded((pid_np // w).astype(np.float32), mesh, P("tile"))
    pid = put_sharded(pid_np, mesh, P("tile"))

    acc = None
    if accum is not None:
        accum = np.asarray(accum, np.float32)
        acc_np = np.zeros((npad, 3), np.float32)
        n = min(npad, accum.shape[0])
        acc_np[:n] = accum[:n]
        acc = put_sharded(acc_np, mesh, P("tile"))

    key = jax.random.key(seed)
    k = samples_per_chunk or (s1 - s0)
    k = max(n_spp, (k // n_spp) * n_spp)

    s = s0
    while s < s1:
        kk = min(k, s1 - s)
        sid = put_sharded(np.arange(s, s + kk, dtype=np.int32),
                          mesh, P("spp"))
        part = kshard._render_chunk(scene, key, px, py, pid, sid,
                                    mesh, cfg, mode, aov)
        acc = part if acc is None else _add_sharded(acc, part)
        s += kk
    return acc


def render_multihost(scene, mesh: Mesh, spp: int = 16, seed: int = 1234,
                     cfg=None, mode: str = "path", aov: str | None = None,
                     clamp: bool = True,
                     samples_per_chunk: int | None = None) -> np.ndarray:
    """Full-frame render on a global (multi-process) mesh -> numpy (H, W, 3)
    replicated on every host.

    Identical decomposition and lane math to dist.shard.render_sharded —
    and therefore bitwise identical to it and to the single-device render —
    but all host<->device traffic goes through per-shard callbacks and one
    final tiled allgather, so it runs under any process topology.
    """
    cam = scene.camera
    w, h = cam.width, cam.height
    npix = w * h
    accum = accumulate_tiles(scene, mesh, (0, spp), seed=seed, cfg=cfg,
                             mode=mode, aov=aov,
                             samples_per_chunk=samples_per_chunk)
    flat = all_gather_host(accum)[:npix] / float(spp)
    img = flat.reshape(h, w, 3)
    if clamp:
        img = np.clip(img, 0.0, 1.0)
    return img


@jax.jit
def _add_sharded(a, b):
    return a + b


def local_film_tiles(arr):
    """[(start_row, stop_row, np.ndarray)] for every shard of a flat
    tile-sharded film array owned by THIS process (replica 0 only, so a
    pod-wide save writes each tile exactly once)."""
    out = []
    for s in arr.addressable_shards:
        if s.replica_id != 0:
            continue
        idx = s.index[0]
        start = idx.start or 0
        data = np.asarray(s.data)
        out.append((start, start + data.shape[0], data))
    return sorted(out, key=lambda t: t[0])


def save_film_tiles(path: str, arr, step: int | None = None,
                    total_rows: int | None = None) -> str:
    """Per-host film checkpoint: each process atomically writes ONLY its own
    tiles to `{path}.proc{k}.npz`. No cross-host traffic. Returns the file."""
    import tempfile
    tiles = local_film_tiles(arr)
    payload = {f"tile_{i}_{a}_{b}": d for i, (a, b, d) in enumerate(tiles)}
    meta = dict(step=step, process=jax.process_index(),
                process_count=jax.process_count(),
                total_rows=total_rows or int(arr.shape[0]))
    out = f"{path}.proc{jax.process_index()}.npz"
    d = os.path.dirname(os.path.abspath(out))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **payload)
        os.replace(tmp, out)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return out


def load_film_tiles(path: str) -> tuple[np.ndarray, int | None]:
    """Reassemble a full film from every per-host tile file written by
    save_film_tiles (any process topology). Returns (array, step)."""
    files, k = [], 0
    while os.path.exists(f"{path}.proc{k}.npz"):
        files.append(f"{path}.proc{k}.npz")
        k += 1
    if not files:
        raise FileNotFoundError(f"no {path}.proc*.npz files")
    full, step = None, None
    for f in files:
        with np.load(f, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            step = meta.get("step")
            if full is None:
                first = z[[n for n in z.files if n != "__meta__"][0]]
                full = np.zeros((meta["total_rows"],) + first.shape[1:],
                                first.dtype)
            for name in z.files:
                if name == "__meta__":
                    continue
                _, _, a, b = name.split("_")
                full[int(a):int(b)] = z[name]
    return full, step
