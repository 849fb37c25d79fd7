"""The port's native host pieces against the JAX package's: the library's
build, the host ops (the port's C++ ops, the reference's C++ ops and the
numpy versions, bit for bit), the tensor codec's frames (byte for byte),
the shm ring across the two packages in both directions and across
processes, and ``ShmDataLoader`` with coworker processes.

Inputs are drawn from seeded ``numpy`` generators. Coworker processes are
spawned with explicit joins and timeouts.
"""

import multiprocessing as mp
import os
import uuid

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from dlrover_tpu.common import tensor_codec as ref_codec
from dlrover_tpu.native import host_ops as ref_ops
from dlrover_tpu.native.shm_ring import ShmBatchRing as RefRing
from dlrover_tpu_torch import native
from dlrover_tpu_torch.common import tensor_codec
from dlrover_tpu_torch.native import host_ops
from dlrover_tpu_torch.native.shm_ring import (
    RingClosed,
    RingTimeout,
    ShmBatchRing,
)
from dlrover_tpu_torch.trainer.shm_dataloader import (
    DevicePrefetcher,
    ShmDataLoader,
)

JOIN_S = 60  # a coworker's join limit


def _name(tag):
    return f"/dlrover_torch_test_{os.getpid()}_{tag}_{uuid.uuid4().hex[:8]}"


class TestBuild:
    def test_library_builds_under_its_own_name(self):
        lib = native.load_library()
        assert lib.shm_ring_create is not None
        assert os.path.basename(native.LIB_PATH) == \
            "libdlrover_tpu_torch_native.so"
        assert os.path.dirname(native.LIB_PATH).endswith(
            os.path.join("dlrover_tpu_torch", "native", "_build"))
        assert os.path.exists(native.LIB_PATH)

    def test_both_libraries_load_in_one_process(self):
        from dlrover_tpu.native import load_library as ref_load

        ours, theirs = native.load_library(), ref_load()
        assert ours._name != theirs._name

    def test_a_failed_build_raises(self, monkeypatch, tmp_path):
        """use_native=True never switches to numpy quietly: a library
        that does not build raises."""
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(native, "LIB_PATH",
                            str(tmp_path / "libbroken.so"))
        monkeypatch.setattr(native, "_SOURCES", ("missing.cc",))
        with pytest.raises((RuntimeError, OSError, FileNotFoundError)):
            native.load_library()
        with pytest.raises((RuntimeError, OSError, FileNotFoundError)):
            host_ops.shuffle_indices(10, 1)

    def test_a_compile_error_raises_with_its_output(self, monkeypatch,
                                                    tmp_path):
        src = tmp_path / "src"
        src.mkdir()
        (src / "bad.cc").write_text("this is not C++\n")
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_SRC_DIR", str(src))
        monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "b"))
        monkeypatch.setattr(native, "LIB_PATH",
                            str(tmp_path / "b" / "lib.so"))
        monkeypatch.setattr(native, "_SOURCES", ("bad.cc",))
        with pytest.raises(RuntimeError, match="did not build"):
            native.load_library()
        assert not (tmp_path / "b" / "lib.so").exists()


class TestHostOps:
    @settings(max_examples=30, deadline=None)
    @given(lens=st.lists(st.integers(0, 40), min_size=0, max_size=12),
           max_len=st.integers(1, 32), pad=st.integers(-5, 5),
           seed=st.integers(0, 2**16))
    def test_pack_sequences_equals_the_reference(self, lens, max_len, pad,
                                                 seed):
        rs = np.random.RandomState(seed)
        tokens = rs.randint(-2**31, 2**31 - 1, size=sum(lens),
                            dtype=np.int64).astype(np.int32)
        offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
        ours = host_ops.pack_sequences(tokens, offsets, max_len, pad)
        plain = host_ops.pack_sequences(tokens, offsets, max_len, pad,
                                        use_native=False)
        theirs = ref_ops.pack_sequences(tokens, offsets, max_len, pad)
        for a, b, c in zip(ours, plain, theirs):
            assert a.dtype == b.dtype == c.dtype == np.int32
            assert a.tobytes() == b.tobytes() == c.tobytes()

    @pytest.mark.parametrize("n", [0, 1, 2, 7, 100, 1000])
    @pytest.mark.parametrize("seed", [0, 42, 2**63 + 5, 2**64 - 1])
    def test_shuffle_indices_bit_for_bit(self, n, seed):
        ours = host_ops.shuffle_indices(n, seed)
        plain = host_ops.shuffle_indices(n, seed, use_native=False)
        theirs = ref_ops.shuffle_indices(n, seed)
        assert ours.dtype == np.int64
        assert ours.tobytes() == plain.tobytes() == theirs.tobytes()
        np.testing.assert_array_equal(np.sort(ours), np.arange(n))

    @settings(max_examples=30, deadline=None)
    @given(rows=st.integers(1, 6), seq=st.integers(1, 24),
           ignore=st.integers(-200, 0), seed=st.integers(0, 2**16))
    def test_shift_labels_equals_the_reference(self, rows, seq, ignore,
                                               seed):
        rs = np.random.RandomState(seed)
        ids = rs.randint(0, 1000, size=(rows, seq)).astype(np.int32)
        mask = (rs.rand(rows, seq) < 0.7).astype(np.int32)
        ours = host_ops.shift_labels(ids, mask, ignore)
        plain = host_ops.shift_labels(ids, mask, ignore, use_native=False)
        theirs = ref_ops.shift_labels(ids, mask, ignore)
        assert ours.tobytes() == plain.tobytes() == theirs.tobytes()

    def test_bad_shapes_raise_before_the_library(self):
        with pytest.raises(ValueError):
            host_ops.pack_sequences(np.arange(4), np.array([0, 9]), 4)
        with pytest.raises(ValueError):
            host_ops.shift_labels(np.zeros((2, 3)), np.zeros((2, 4)))


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {
        "input_ids": rs.randint(0, 258, size=(2, 33)).astype(np.int32),
        "segment_ids": rs.randint(-1, 5, size=(2, 33)).astype(np.int32),
        "mask": rs.rand(3, 1) < 0.5,
        "x": rs.randn(4, 5).astype(np.float32),
        "y": rs.randn(7).astype(np.float64),
        "half": np.asarray([3.5], np.float16),
        "empty": np.zeros((0, 3), np.int64),
    }


class TestCodec:
    @pytest.mark.parametrize("seed", range(4))
    def test_frames_are_byte_equal(self, seed):
        batch = _batch(seed)
        meta = {"step": seed, "tag": "x" * seed}
        frame = tensor_codec.pack_frame(meta, batch)
        assert frame == ref_codec.pack_frame(meta, batch)
        for unpack in (tensor_codec.unpack_frame, ref_codec.unpack_frame):
            got_meta, got = unpack(frame, copy=True)
            assert got_meta == meta
            for k, v in batch.items():
                assert got[k].dtype == v.dtype and got[k].shape == v.shape
                assert got[k].tobytes() == v.tobytes()

    def test_non_contiguous_arrays_frame_as_their_values(self):
        a = np.arange(24, dtype=np.int32).reshape(4, 6)[:, ::2]
        assert tensor_codec.pack_frame({}, {"a": a}) == \
            ref_codec.pack_frame({}, {"a": a})
        assert tensor_codec.pack_frame({}) == ref_codec.pack_frame({})


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes()


class TestShmRing:
    @pytest.mark.parametrize("creator", ["port", "reference"])
    def test_rings_read_each_other(self, creator):
        name = _name(creator)
        own_cls, other_cls = ((ShmBatchRing, RefRing) if creator == "port"
                              else (RefRing, ShmBatchRing))
        owner = own_cls(name, slot_bytes=1 << 16, n_slots=4)
        other = other_cls.attach(name)
        try:
            for seed in range(3):
                owner.put(_batch(seed))
                _same(other.get(timeout=5), _batch(seed))
                other.put(_batch(10 + seed))
                _same(owner.get(timeout=5), _batch(10 + seed))
            assert other.qsize() == owner.qsize() == 0
            owner.put(_batch(5))
            other.close()
            _same(owner.get(timeout=5), _batch(5))
            with pytest.raises(Exception, match="closed"):
                owner.get(timeout=5)
        finally:
            other.free()
            owner.free()

    def test_timeout_oversize_and_close(self):
        with ShmBatchRing(_name("edge"), slot_bytes=256, n_slots=2) as ring:
            with pytest.raises(RingTimeout):
                ring.get(timeout=0.05)
            with pytest.raises(ValueError):
                ring.put({"x": np.zeros(1000, np.float32)})
            ring.put({"x": np.ones(2, np.float32)})
            ring.close()
            np.testing.assert_array_equal(ring.get()["x"], np.ones(2))
            with pytest.raises(RingClosed):
                ring.get(timeout=5)
            with pytest.raises(RingClosed):
                ring.put({"x": np.ones(2, np.float32)})

    @pytest.mark.parametrize("producer", ["port", "reference"])
    def test_cross_process(self, producer):
        """A spawned process pushes through one package's ring; this
        process reads with the other's."""
        name = _name(f"xp{producer}")
        reader_cls = RefRing if producer == "port" else ShmBatchRing
        ring = reader_cls(name, slot_bytes=1 << 16, n_slots=4)
        proc = mp.get_context("spawn").Process(
            target=_push_entry, args=(name, 5, producer), daemon=True)
        proc.start()
        got = []
        try:
            while True:
                try:
                    got.append(ring.get(timeout=JOIN_S))
                except Exception as e:  # either package's RingClosed
                    assert "closed" in str(e)
                    break
            proc.join(timeout=JOIN_S)
            assert not proc.is_alive() and proc.exitcode == 0
        finally:
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=10)
            ring.free()
        assert len(got) == 5
        for i, b in enumerate(got):
            _same(b, _batch(i))


def _push_entry(name, n, package):
    if package == "port":
        from dlrover_tpu_torch.native.shm_ring import ShmBatchRing as cls
    else:
        from dlrover_tpu.native.shm_ring import ShmBatchRing as cls
    ring = cls.attach(name)
    for i in range(n):
        ring.put(_batch(i))
    ring.close()
    ring.free()


def _range_producer(rank, num_workers):
    for i in range(rank, 8, num_workers):
        yield {"value": np.full((3,), i, np.int32),
               "x": np.random.RandomState(i).randn(2, 2)}


def _failing_producer(rank, num_workers):
    yield {"value": np.zeros(1, np.int32)}
    raise RuntimeError("coworker died")


class TestShmDataLoader:
    def test_coworkers_end_to_end_and_shut_down(self):
        loader = ShmDataLoader(_range_producer, num_workers=2,
                               slot_bytes=1 << 16, n_slots=4, timeout=JOIN_S)
        try:
            assert loader.name.startswith("/dlrover_torch_shm_")
            batches = list(loader)
        finally:
            clean = loader.shutdown(timeout=JOIN_S)
        assert clean
        seen = sorted(int(b["value"][0]) for b in batches)
        assert seen == list(range(8))
        for b in batches:
            i = int(b["value"][0])
            np.testing.assert_array_equal(
                b["x"], np.random.RandomState(i).randn(2, 2))

    def test_a_dead_coworker_ends_the_stream(self):
        loader = ShmDataLoader(_failing_producer, num_workers=1,
                               slot_bytes=1 << 12, n_slots=2, timeout=8.0)
        try:
            got = list(loader)
        finally:
            clean = loader.shutdown(timeout=JOIN_S)
        assert len(got) == 1
        assert not clean  # the coworker exited with an error

    def test_prefetcher_on_the_cpu(self):
        """DevicePrefetcher is DevicePreloader in background mode: with
        put_fn it keeps order; without it, batches land on the device it
        was given."""
        out = list(DevicePrefetcher(iter(range(10)), lambda x: x * 2))
        assert out == [x * 2 for x in range(10)]
        loader = ShmDataLoader(_range_producer, num_workers=1,
                               slot_bytes=1 << 16, n_slots=4, timeout=JOIN_S)
        try:
            pre = DevicePrefetcher(iter(loader), depth=2, device="cpu")
            got = list(pre)
            pre.close()
        finally:
            assert loader.shutdown(timeout=JOIN_S)
        assert [int(b["value"][0]) for b in got] == list(range(8))
        assert all(b["value"].device.type == "cpu" for b in got)

    def test_prefetcher_asks_for_the_card_by_default(self):
        import torch

        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DevicePrefetcher(iter(range(3)))
