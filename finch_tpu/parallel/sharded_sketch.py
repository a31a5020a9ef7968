"""Data-parallel sketching over a device mesh.

One logical k-mer stream is split across devices; each device folds its
shard into a local bottom-k state (ops/bottomk.py); states merge exactly at
finalization via all-gather + dedup (counts add on equal hashes — the
batch-equivalence theorem makes this bit-identical to a single stream).

This is the device replacement for the reference's single-threaded
per-file loop (lib/src/lib.rs:51-94), scaled over the mesh with XLA
collectives under shard_map.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from finch_tpu.models.params import SketchParams
from finch_tpu.ops import bottomk
from finch_tpu.ops.bottomk import U64_MAX


@partial(jax.jit, static_argnames=("k", "seed", "has_max_hash", "mesh",
                                   "axis", "composite"))
def _sharded_step(state, batch_packed, batch_rc, nvalid, max_hash,
                  *, k, seed, has_max_hash, mesh, axis, composite=False):
    """state: (n, C) arrays sharded on axis 0; batch: (n, B) sharded on
    axis 0; nvalid: (n,) per-shard valid counts."""

    def body(st, pk, rc, nv, mh):
        st = jax.tree.map(lambda x: x[0], st)
        new_state, below = bottomk.sketch_step(
            st, pk[0], rc[0], nv[0], mh,
            k=k, seed=seed, has_max_hash=has_max_hash,
            composite=composite)
        below = jax.lax.psum(below, axis)
        return (jax.tree.map(lambda x: x[None], new_state), below[None])

    spec = P(axis)
    st_spec = (spec,) * 6
    return shard_map(
        body, mesh=mesh,
        in_specs=(st_spec, spec, spec, spec, P()),
        out_specs=(st_spec, spec),
    )(state, batch_packed, batch_rc, nvalid, max_hash)


@partial(jax.jit, static_argnames=("mesh", "axis", "k", "seed"))
def _sharded_finalize(state, *, mesh, axis, k, seed):
    """All-gather per-device states and merge into one exact bottom-k."""

    def body(st):
        full = jax.tree.map(
            lambda x: jax.lax.all_gather(x[0], axis, axis=0), st)
        n = full[0].shape[0]
        states = [jax.tree.map(lambda x: x[i], full) for i in range(n)]
        merged = bottomk.merge_states(states, k=k, seed=seed)
        return jax.tree.map(lambda x: x[None], merged)

    spec = P(axis)
    st_spec = (spec,) * 6
    return shard_map(
        body, mesh=mesh,
        in_specs=(st_spec,),
        out_specs=st_spec,
    )(state)


@partial(jax.jit, static_argnames=("old_cap",))
def _grow_cols(old, template, old_cap: int):
    return jnp.concatenate([old, template[:, old_cap:]], axis=1)


@jax.jit
def _copy_spill(old_sp, new_sp):
    return jax.lax.dynamic_update_slice(
        new_sp, old_sp, (jnp.int32(0), jnp.int32(0)))


class ShardedSketchEngine:
    """Mesh-parallel analog of models.engine.JaxEngine.

    Bit-identical to the single-device engine: the per-device prefilter uses
    each shard's local threshold (a superset of admissions), and the final
    all-gather merge recovers the exact global bottom-k with exact counts.
    """

    def __init__(self, params: SketchParams, mesh: Mesh,
                 axis: str = "data", batch_size_per_device: int = 1 << 20,
                 process_local: bool = False):
        """process_local=True: multi-host mode — every process calls
        update() with ITS OWN portion of the stream (equal batch shapes
        across processes; pad the final batch), state rows live on the
        process's addressable devices, and the finalize all-gather merges
        globally. Exactness is order-independent (the
        monotone-max theorem), so any split of the stream is exact.
        See parallel/distributed.py for initialization."""
        self.params = params
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.devices.size
        self.process_local = process_local
        if process_local:
            import jax as _jax

            self.n_local = self.n // _jax.process_count()
        else:
            self.n_local = self.n
        self.size = params.kmers_to_sketch
        self.max_hash = params.max_hash()
        self.bpd = batch_size_per_device
        if params.sketch_type == "mash":
            self.capacity = max(1, self.size)
        else:
            self.capacity = max(2 * self.size, 1 << 12)
        self._sharding = NamedSharding(mesh, P(axis))
        self.state = self._empty_state(self.capacity)
        self._mh = (jnp.uint64(self.max_hash) if self.max_hash is not None
                    else jnp.uint64(0))
        self.wants_composite = False

    def _put(self, local_rows: np.ndarray):
        """Place (n_local, ...) process-local rows as the process's part
        of the globally (axis-0) sharded array."""
        if self.process_local:
            return jax.make_array_from_process_local_data(
                self._sharding, local_rows)
        return jax.device_put(local_rows, self._sharding)

    def _empty_state(self, capacity):
        n = self.n_local
        sp = bottomk.spill_capacity(capacity)
        mk = lambda shape, fill, dt: self._put(
            np.full(shape, fill, dtype=dt))
        u64max = np.uint64(0xFFFFFFFFFFFFFFFF)
        return (mk((n, capacity), u64max, np.uint64),
                mk((n, capacity), 0, np.uint64),
                mk((n, capacity), 0, np.uint64),
                mk((n, capacity), 0, np.uint64),
                mk((n, sp), u64max, np.uint64),
                mk((n, 1), 0, np.int32))

    def update(self, packed: np.ndarray, rc: np.ndarray) -> None:
        total = len(packed)
        per_dev_cap = self.n_local * self.bpd
        for off in range(0, max(total, 1), per_dev_cap):
            chunk_pk = packed[off: off + per_dev_cap]
            chunk_rc = rc[off: off + per_dev_cap]
            if len(chunk_pk) == 0 and off > 0:
                break
            self._step(chunk_pk, chunk_rc)
            if len(chunk_pk) < per_dev_cap:
                break

    @staticmethod
    def _bucket(n: int) -> int:
        from finch_tpu.ops.bottomk import bucket_pow2

        return bucket_pow2(n)

    def _step(self, pk: np.ndarray, rc: np.ndarray) -> None:
        n = self.n_local
        total = len(pk)
        composite = pk.dtype == np.uint32
        # multi-process: the jitted program's shapes must agree across
        # processes, so the shard width is the fixed bpd, not data-derived
        per_shard = (self._bucket(self.bpd) if self.process_local
                     else self._bucket((total + n - 1) // n))
        pk_pad = np.zeros((n, per_shard),
                          dtype=np.uint32 if composite else np.uint64)
        rc_pad = np.zeros((n, per_shard),
                          dtype=np.uint32 if composite else np.uint8)
        nvalid = np.zeros((n,), dtype=np.uint32)
        for i in range(n):
            sl = slice(i * per_shard, min((i + 1) * per_shard, total))
            cnt = max(0, sl.stop - sl.start)
            if cnt:
                pk_pad[i, :cnt] = pk[sl]
                rc_pad[i, :cnt] = rc[sl]
            nvalid[i] = cnt
        pk_d = self._put(pk_pad)
        rc_d = self._put(rc_pad)
        nv_d = self._put(nvalid)
        is_scaled = self.params.sketch_type == "scaled"
        while True:
            new_state, below = _sharded_step(
                self.state, pk_d, rc_d, nv_d, self._mh,
                k=self.params.k, seed=self.params.hash_seed,
                has_max_hash=is_scaled, mesh=self.mesh, axis=self.axis,
                composite=composite)
            if not is_scaled:
                self.state = new_state
                return
            below_total = int(np.asarray(below)[0])
            if below_total + self.size <= self.capacity:
                self.state = new_state
                return
            new_cap = max(self.capacity * 2, below_total + self.size)
            old = self.state
            tmpl = self._empty_state(new_cap)
            # grow on device (axis 1 is unsharded, so concatenation is
            # shard-local and works in multi-process mode too)
            grown = [
                _grow_cols(o, t, self.capacity)
                for o, t in zip(old[:4], tmpl[:4])]
            new_sp = _copy_spill(old[4], tmpl[4])
            self.state = (*grown, new_sp, old[5])
            self.capacity = new_cap

    def _merged_arrays(self):
        merged = _sharded_finalize(self.state, mesh=self.mesh,
                                   axis=self.axis, k=self.params.k,
                                   seed=self.params.hash_seed)
        # every shard row holds the same merged result; read it from this
        # process's first addressable shard (multi-process safe)
        out = []
        for x in merged[:4]:
            if self.process_local:
                out.append(np.asarray(x.addressable_shards[0].data)[0])
            else:
                out.append(np.asarray(x)[0])
        return tuple(out)

    def finalize(self):
        from finch_tpu.models.engine import _finalize

        return _finalize(self.params, *self._merged_arrays())

    def finalize_arrays(self):
        from finch_tpu.models.engine import _finalize_arrays

        return _finalize_arrays(self.params, *self._merged_arrays())
