"""Ragged all-to-all locus redistribution tests (virtual 8-device mesh)."""

import numpy as np
import pytest

import jax

from telr_jax.dist.mesh import make_mesh
from telr_jax.dist.redistribute import (make_redistribute_step, owner_of,
                                        pack_sends, redistribute_host,
                                        unpack_received)


def _random_pairs(rng, n_shards, per_shard=30, n_loci=17, n_reads=500):
    return [[(int(rng.integers(0, n_loci)), int(rng.integers(0, n_reads)))
             for _ in range(per_shard)] for _ in range(n_shards)]


def test_host_reference_routing():
    pairs = [[(0, 1), (3, 2)], [(0, 5), (1, 9)]]
    out = redistribute_host(pairs, 2)
    assert out[0] == [(0, 1), (0, 5)]
    assert out[1] == [(1, 9), (3, 2)]


@pytest.mark.usefixtures("eight_devices")
def test_device_all_to_all_matches_reference():
    rng = np.random.default_rng(0)
    n = 8
    mesh = make_mesh(n, loci_parallel=1)
    pairs = _random_pairs(rng, n)
    want = redistribute_host(pairs, n)

    cap = 32
    sends = pack_sends(pairs, n, cap)
    step = make_redistribute_step(mesh, cap)
    received = np.asarray(step(sends))
    got = unpack_received(received)
    assert got == want
    # ownership invariant: every pair landed on its owner
    for dst, lst in enumerate(got):
        for locus_id, _ in lst:
            assert owner_of(locus_id, n) == dst


def test_capacity_overflow_raises():
    pairs = [[(0, i) for i in range(5)]]
    with pytest.raises(ValueError):
        pack_sends(pairs, 1, capacity=4)


@pytest.mark.usefixtures("eight_devices")
def test_payload_all_to_all_moves_read_codes():
    """The payload collective must deliver every (locus, rank, kind) item
    to the locus' owner with its read codes intact."""
    from telr_jax.dist.redistribute import redistribute_payloads

    rng = np.random.default_rng(1)
    n = 8
    mesh = make_mesh(n, loci_parallel=1)
    truth = {}
    items_per_shard = [[] for _ in range(n)]
    for k in range(200):
        li = int(rng.integers(0, 23))
        rank = k
        kind = int(rng.integers(0, 2))
        codes = rng.integers(0, 4, int(rng.integers(1, 900))).astype(np.int8)
        src = int(rng.integers(0, n))
        items_per_shard[src].append((li, rank, kind, codes))
        truth[(li, rank, kind)] = codes
    merged = redistribute_payloads(mesh, items_per_shard,
                                   max_bytes=1 << 20)  # force chunked rounds
    seen = {}
    for dst, lst in enumerate(merged):
        for li, rank, kind, codes in lst:
            assert owner_of(li, n) == dst
            seen[(li, rank, kind)] = codes
    assert set(seen) == set(truth)
    for key, codes in seen.items():
        np.testing.assert_array_equal(codes, truth[key])


def test_exchange_bytes_roundtrip():
    """exchange_bytes_mp self-route (P=1 degenerate) returns the blob."""
    import jax
    from jax.sharding import Mesh
    from telr_jax.dist.mesh import READS_AXIS
    from telr_jax.dist.redistribute import exchange_bytes_mp
    import numpy as np

    mesh = Mesh(np.array(jax.devices()[:1]), (READS_AXIS,))
    blob = bytes(range(256)) * 100 + b"tail"
    got = exchange_bytes_mp(mesh, [blob])
    assert got == [blob]


def test_exchange_bytes_chunking():
    """Blobs larger than one chunk reassemble exactly, including bytes
    equal to the -1 pad value."""
    import jax
    from jax.sharding import Mesh
    from telr_jax.dist.mesh import READS_AXIS
    from telr_jax.dist.redistribute import exchange_bytes_mp
    import numpy as np

    mesh = Mesh(np.array(jax.devices()[:1]), (READS_AXIS,))
    rng = np.random.default_rng(0)
    blob = rng.integers(0, 256, 3_000_000, dtype=np.uint8).tobytes()
    got = exchange_bytes_mp(mesh, [blob], chunk=1 << 19)
    assert got == [blob]
