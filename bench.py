"""Benchmark: k-mers hashed + bottom-k-sketched per second on one device.

Streams fresh 4M-k-mer batches through the device sketch step
(ops/bottomk.py). Each step's batch is a pregenerated uniform pool xor'd
with a per-step 42-bit constant: fresh k-mers every step without paying
the PRNG in the loop. The timed steps run inside one dispatch
(lax.fori_loop) that ends in block_until_ready. Prints ONE JSON line
naming the device; refuses to run without a GPU. vs_baseline compares
against the reference's derived single-core throughput: finch-rs
sketches a 4.8 GB FASTQ in 99 s on a 2015 MacBook Pro (~4e7 k-mers/s;
the reference README and BASELINE.md).
"""

import json
import sys
import time

BASELINE_KMERS_PER_SEC = 4.0e7  # single-core finch-rs (BASELINE.md)


def main() -> None:
    import jax
    import jax.numpy as jnp

    import finch_tpu  # noqa: F401  (enables x64)
    from finch_tpu.ops import bottomk

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {device}")

    k = 21
    size = 1000
    cap = size * 200   # filtered-mash working state (cli.rs:287)
    batch = 1 << 22    # 4M k-mers per device step
    for a in sys.argv[1:]:
        if a.startswith("--batch="):
            batch = int(a.split("=", 1)[1])
    warm_steps = 8     # decay the admission threshold to steady state
    timed_steps = 32

    key = jax.random.PRNGKey(0)
    lo = jax.random.bits(key, (batch,), dtype=jnp.uint32)
    hi = jax.random.bits(jax.random.fold_in(key, 1), (batch,),
                         dtype=jnp.uint32)
    pool = ((hi.astype(jnp.uint64) << jnp.uint64(32))
            | lo.astype(jnp.uint64)) & jnp.uint64(4 ** k - 1)
    rc = (lo & jnp.uint32(1)).astype(jnp.uint8)

    def one_step(i, state, pool, rc):
        # xor-perturb the packed bits: fresh k-mers each step, same rc
        mask = (i.astype(jnp.uint64)
                * jnp.uint64(0x9E3779B97F4A7C15)) & jnp.uint64(4 ** k - 1)
        new_state, _ = bottomk.sketch_step(
            state, pool ^ mask, rc, jnp.uint32(batch), jnp.uint64(0),
            k=k, seed=0, has_max_hash=False)
        return new_state

    @jax.jit
    def run(state, pool, rc, start, nsteps):
        return jax.lax.fori_loop(
            start, start + nsteps,
            lambda i, s: one_step(i.astype(jnp.uint32), s, pool, rc), state)

    def measure_stream(plo, prc, warm):
        """k-mers/s over `timed_steps` steps after `warm` steps from an
        empty state. Duplicate streams carry 64x fewer distinct values
        per batch, so their threshold needs more steps to reach the
        steady state."""
        s = bottomk.empty_state(cap)
        s = jax.block_until_ready(
            run(s, plo, prc, jnp.int32(0), jnp.int32(warm)))
        t0 = time.perf_counter()
        s = jax.block_until_ready(
            run(s, plo, prc, jnp.int32(warm), jnp.int32(timed_steps)))
        return batch * timed_steps / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    jax.block_until_ready(run(bottomk.empty_state(cap), pool, rc,
                              jnp.int32(0), jnp.int32(1)))
    compile_s = time.perf_counter() - t0

    uniform = measure_stream(pool, rc, warm_steps)
    # duplicate-burst stream: every value appears 64x within each batch,
    # copies one 64th of a batch apart...
    dup_pool = jnp.tile(pool[: batch // 64], 64)
    dup_rc = jnp.tile(rc[: batch // 64], 64)
    worst = measure_stream(dup_pool, dup_rc, warm=128)
    # ...and the same 64x multiset with copies randomly permuted
    perm = jax.random.permutation(jax.random.PRNGKey(7), batch)
    shuf = measure_stream(dup_pool[perm], dup_rc[perm], warm=128)

    print(json.dumps({
        "metric": "kmers_sketched_per_sec_per_chip",
        "value": uniform,
        "unit": "kmers/s/chip",
        "vs_baseline": uniform / BASELINE_KMERS_PER_SEC,
        "worst_case_dup64": worst,
        "worst_case_dup_shuffle": shuf,
        "setup_compile_s": compile_s,
        "device": device,
    }))


if __name__ == "__main__":
    main()
