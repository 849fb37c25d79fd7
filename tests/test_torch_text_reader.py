"""The port's text reader against the JAX package's: ``LineIndexedFile``,
``ByteTokenizer``, ``HFTokenizerAdapter`` (an in-memory ``tokenizers``
tokenizer) and ``ShardedTextBatches`` in padded and packed modes, equal
batches and the same sequence of calls to the shard source, driven by the
reference's local master and ``ShardingClient`` (neither imports JAX), or
by a stub source with explicit record permutations. Then phase 13's rows:
``chip_smoke.py``'s corpus writer packed by the port reproduces
``packed_segment_rows(4096, PACK_SEED)`` row for row.

Everything is bit for bit: the reader is integer work.
"""

import os
import sys
import types

import numpy as np
import pytest

from dlrover_tpu.agent.master_client import MasterClient
from dlrover_tpu.agent.sharding_client import ShardingClient
from dlrover_tpu.master.local_master import start_local_master
from dlrover_tpu.trainer import text_reader as ref
from dlrover_tpu_torch.trainer import text_reader as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """``chip_smoke.py`` imported by its own name from the repository's
    root (on ``sys.path``, which a spawned coworker inherits, so the
    script's producer unpickles there)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


@pytest.fixture()
def corpus(tmp_path):
    """Lines of seeded random printable bytes, 0 to 90 long, a few with
    CRLF endings; no trailing newline at the end."""
    rs = np.random.RandomState(7)
    lines = [rs.randint(32, 127, size=rs.randint(0, 90)).astype(np.uint8)
             .tobytes() for _ in range(120)]
    ends = [b"\r\n" if i % 17 == 3 else b"\n" for i in range(len(lines))]
    data = b"".join(line + end for line, end in zip(lines, ends))
    path = tmp_path / "corpus.txt"
    path.write_bytes(data[:-1])
    return str(path), lines


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert g[k].tobytes() == w[k].tobytes(), k


class Recording:
    """Forwards the reader's calls to a shard source and records them."""

    def __init__(self, client):
        self._client = client
        self.calls = []

    def fetch_shard(self):
        shard = self._client.fetch_shard()
        self.calls.append(("fetch", None if shard is None else (
            shard.start, shard.end, list(shard.record_indices or []))))
        return shard

    @property
    def current_task_id(self):
        return self._client.current_task_id

    def report_batch_done(self, *args):
        self.calls.append(("batch_done",) + args)
        return self._client.report_batch_done(*args)

    def report_task_done(self, *args):
        self.calls.append(("task_done",) + args)
        return self._client.report_task_done(*args)

    def report_task_done_by_id(self, task_id, *args):
        self.calls.append(("task_done_by_id", task_id) + args)
        return self._client.report_task_done_by_id(task_id, *args)


class StubShards:
    """Shards of ``per`` records over a seeded permutation of ``count``
    records (``record_indices`` set), or plain ranges."""

    def __init__(self, count, per, seed=None):
        order = (np.random.RandomState(seed).permutation(count)
                 if seed is not None else None)
        self._shards = [
            types.SimpleNamespace(
                start=lo, end=min(count, lo + per),
                record_indices=(None if order is None else
                                [int(i) for i in order[lo:lo + per]]))
            for lo in range(0, count, per)]
        self.current_task_id = None

    def fetch_shard(self):
        if not self._shards:
            self.current_task_id = None
            return None
        self.current_task_id = 0 if self.current_task_id is None else \
            self.current_task_id + 1
        return self._shards.pop(0)

    def report_batch_done(self, *args):
        pass

    def report_task_done(self, *args):
        pass

    def report_task_done_by_id(self, task_id, *args):
        pass


class TestLineIndexedFile:
    def test_count_ranges_and_indices_equal(self, corpus):
        path, lines = corpus
        ours, theirs = port.LineIndexedFile(path), ref.LineIndexedFile(path)
        assert ours.count() == theirs.count() == len(lines)
        for lo, hi in ((0, 5), (10, 13), (110, 999), (50, 50), (130, 140)):
            assert ours.read_range(lo, hi) == theirs.read_range(lo, hi)
        assert ours.read_range(0, 120) == lines
        rs = np.random.RandomState(0)
        for _ in range(5):
            idx = [int(i) for i in rs.randint(0, 130, size=25)]
            idx += list(range(40, 48))  # a contiguous run
            assert ours.read_indices(idx) == theirs.read_indices(idx)

    def test_edges(self, tmp_path):
        path = tmp_path / "edge.txt"
        path.write_bytes(b"alpha\r\nbeta\n\ngamma")
        ours = port.LineIndexedFile(str(path))
        assert ours.count() == 4
        assert ours.read_range(0, 9) == [b"alpha", b"beta", b"", b"gamma"]
        assert ours.read_indices([3, 0, 7]) == [b"gamma", b"alpha"]


class TestTokenizers:
    @pytest.mark.parametrize("seq", [1, 2, 8, 64])
    def test_byte_tokenizer_equal(self, corpus, seq):
        _, lines = corpus
        ours, theirs = port.ByteTokenizer(seq), ref.ByteTokenizer(seq)
        assert ours.vocab_size == theirs.vocab_size == 258
        for line in lines[:40]:
            assert ours(line).tobytes() == theirs(line).tobytes()
            assert ours.encode(line).tobytes() == theirs.encode(line).tobytes()

    def _hf(self):
        from tokenizers import Tokenizer, models
        from tokenizers.pre_tokenizers import Whitespace

        vocab = {"<pad>": 0, "<bos>": 1, "<unk>": 2, "<eos>": 3}
        for i, w in enumerate(["line", "number", "with", "some", "text"]
                              + [str(n) for n in range(100)]):
            vocab[w] = i + 4
        t = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
        t.pre_tokenizer = Whitespace()
        return t

    @pytest.mark.parametrize("bos, eos", [(None, None), (1, None), (1, 3),
                                          (None, 0)])
    def test_hf_adapter_equal(self, bos, eos):
        tok = self._hf()
        kw = dict(seq_len=6, pad_id=0, bos_id=bos, eos_id=eos)
        ours = port.HFTokenizerAdapter(tok, **kw)
        theirs = ref.HFTokenizerAdapter(tok, **kw)
        assert ours.vocab_size == theirs.vocab_size == 109
        for i in range(30):
            rec = f"line number {i} with some text {i * 7} words".encode()
            assert ours(rec).tobytes() == theirs(rec).tobytes()
            assert ours.encode(rec).tobytes() == theirs.encode(rec).tobytes()


def _master_batches(module, path, name, batch, seq, pack, tokenizer=None,
                    minibatches=2):
    """``module``'s ShardedTextBatches over ``path``, fed by a fresh local
    master: (batches, the reader's calls to its shard source)."""
    master = start_local_master()
    client = MasterClient(master.addr, node_id=0)
    try:
        reader = module.LineIndexedFile(path)
        shards = Recording(ShardingClient(
            client, dataset_name=name, batch_size=batch,
            dataset_size=reader.count(), num_epochs=1,
            num_minibatches_per_shard=minibatches))
        source = module.ShardedTextBatches(
            shards, reader, batch_size=batch, tokenizer=tokenizer,
            seq_len=seq, pack=pack)
        batches = list(source)
        dataset = master.task_manager.get_dataset(name)
        return batches, shards.calls, (len(dataset.todo),
                                       len(dataset.doing))
    finally:
        client.close()
        master.stop()


class TestShardedTextBatches:
    @pytest.mark.parametrize("pack, batch, seq", [
        (False, 4, 64), (False, 3, 16), (True, 2, 48), (True, 3, 512)])
    def test_master_fed_batches_and_calls_equal(self, corpus, pack, batch,
                                                seq):
        path, _ = corpus
        got, calls, left = _master_batches(port, path, "ds", batch, seq,
                                           pack)
        want, want_calls, want_left = _master_batches(ref, path, "ds",
                                                      batch, seq, pack)
        _same_batches(got, want)
        assert calls == want_calls
        assert left == want_left == (0, 0)  # every shard completed
        kinds = {c[0] for c in calls}
        if pack:
            # packed rows are not records: no batch credit, every task
            # completed by id once its rows were yielded
            assert "batch_done" not in kinds and "task_done_by_id" in kinds
        else:
            assert "batch_done" in kinds and "task_done" in kinds

    def test_hf_tokenizer_through_the_master(self, corpus, tmp_path):
        path = tmp_path / "words.txt"
        path.write_text("\n".join(f"line number {i} with some text"
                                  for i in range(30)) + "\n")
        tok = TestTokenizers()._hf()
        for pack in (False, True):
            adapters = [m.HFTokenizerAdapter(tok, seq_len=16, pad_id=0,
                                             bos_id=1) for m in (port, ref)]
            got, calls, _ = _master_batches(port, str(path), "hf", 4, 16,
                                            pack, adapters[0])
            want, want_calls, _ = _master_batches(ref, str(path), "hf", 4,
                                                  16, pack, adapters[1])
            _same_batches(got, want)
            assert calls == want_calls

    @pytest.mark.parametrize("pack", [False, True])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_shuffled_shards_equal(self, corpus, pack, seed):
        """Shards that carry a permutation (``record_indices``) are read
        in its order; the calls match the reference's too."""
        path, _ = corpus
        outs = []
        for module in (port, ref):
            shards = Recording(StubShards(130, 16, seed=seed))
            source = module.ShardedTextBatches(
                shards, module.LineIndexedFile(path), batch_size=3,
                seq_len=40, pack=pack)
            outs.append((list(source), shards.calls))
        _same_batches(outs[0][0], outs[1][0])
        assert outs[0][1] == outs[1][1]

    def test_packed_rows_hold_the_rules(self, corpus):
        """Segments restart at each document, labels stay inside a
        segment, pads carry -1 and no label, and the flush tail's filler
        rows (a batch size that does not divide the row count) train
        nothing."""
        path, _ = corpus

        def packed(batch):
            return list(port.ShardedTextBatches(
                StubShards(120, 10), port.LineIndexedFile(path),
                batch_size=batch, seq_len=100, pack=True))

        n_rows = len(packed(1))
        batch = next(b for b in (4, 5, 3, 7) if n_rows % b)
        batches = packed(batch)
        assert len(batches) == -(-n_rows // batch)
        for b in batches:
            for ids, segs, labels in zip(b["input_ids"], b["segment_ids"],
                                         b["labels"]):
                trained = labels != -100
                assert (segs[trained] >= 0).all()
                assert (~trained[:-1] | (segs[:-1] == segs[1:])).all()
                assert not trained[-1]
                np.testing.assert_array_equal(labels[:-1][trained[:-1]],
                                              ids[1:][trained[:-1]])
                assert (ids[segs == -1] == 0).all()
        last, real = batches[-1], n_rows % batch
        for i in range(real, batch):
            np.testing.assert_array_equal(last["input_ids"][i],
                                          last["input_ids"][real - 1])
            assert (last["labels"][i] == -100).all()
        assert (last["labels"][real - 1] != -100).any()


class _IdTok:
    """A tokenizer whose pad id is also a real token id (the pad == eos
    convention), with or without a declared eos id."""

    pad_id = 7
    vocab_size = 16

    def __init__(self, seq, eos_id=None, body=(3, 7, 4)):
        self.seq_len, self.eos_id, self._body = seq, eos_id, body

    def __call__(self, record):
        ids = np.full((self.seq_len,), 7, np.int32)
        n = min(len(self._body), self.seq_len)
        ids[:n] = self._body[:n]
        return ids


class TestRenderMasking:
    @pytest.mark.parametrize("eos", [None, 7])
    @pytest.mark.parametrize("body", [(3, 7, 4), (3, 4, 5), (7, 7),
                                      (1, 2, 3, 4, 5, 6, 7, 8), ()])
    def test_pad_equals_eos_equal(self, eos, body):
        records = [b"x"] * 3
        outs = []
        for module in (port, ref):
            source = module.ShardedTextBatches(
                StubShards(3, 3), None, batch_size=3,
                tokenizer=_IdTok(8, eos, body), seq_len=8)
            outs.append(source._render(records))
        _same_batches([outs[0]], [outs[1]])

    def test_terminal_eos_target_survives(self):
        source = port.ShardedTextBatches(
            StubShards(1, 1), None, batch_size=1,
            tokenizer=_IdTok(8, 7, (3, 4, 5)), seq_len=8)
        labels = source._render([b"x"])["labels"][0]
        # labels[2] predicts ids[3], the document's terminal EOS (7)
        assert labels[:4].tolist() == [4, 5, 7, -100]
        assert (labels[3:] == -100).all()
        source = port.ShardedTextBatches(
            StubShards(1, 1), None, batch_size=1,
            tokenizer=_IdTok(8, None, (3, 7, 4)), seq_len=8)
        # an interior token sharing the pad id keeps its label
        assert source._render([b"x"])["labels"][0][:2].tolist() == [7, 4]


class TestPhase13Rows:
    def test_the_packer_reproduces_packed_segment_rows(self, tmp_path):
        """``chip_smoke.py``'s corpus packed by the port (batch 1, seq
        4096, pack=True) gives ``packed_segment_rows(4096, PACK_SEED)``
        row for row; the reference's packer gives the same rows bit for
        bit; the first row's documents are phase 13's layout."""
        cs = _chip_smoke()
        path = str(tmp_path / "corpus.txt")
        lengths = cs.write_packed_corpus(path)
        assert cs.SEQ == 4096 and cs.PACK_SEED == 0
        assert len(lengths) == len(cs.document_lengths(cs.SEQ, 0, cs.STEPS))
        source, shards = cs.packed_reader(path)
        rows = list(source)
        want = cs.packed_segment_rows(cs.SEQ, cs.PACK_SEED)
        full = [r for r in rows if (r["segment_ids"] >= 0).all()]
        assert len(full) >= cs.STEPS
        for row in full:
            np.testing.assert_array_equal(row["segment_ids"][0], next(want))
        first = cs.segment_lengths(rows[0]["segment_ids"][0])
        assert list(first) == [627, 1253, 785, 617, 373, 441]
        for r in rows:
            ids = r["input_ids"][0]
            assert ids.dtype == np.int32
            live = r["segment_ids"][0] >= 0
            assert ((ids[live] >= 1) & (ids[live] <= 257)).all()
            # each document starts with the byte tokenizer's BOS
            starts = np.flatnonzero(np.diff(r["segment_ids"][0],
                                            prepend=-2) != 0)
            starts = [s for s in starts if live[s]]
            assert (ids[starts[1:]] == 1).all()
        # the reference's packer over the same corpus and shard source
        theirs = list(ref.ShardedTextBatches(
            cs.LineShards(len(lengths)), ref.LineIndexedFile(path), 1,
            seq_len=cs.SEQ, pack=True))
        _same_batches(rows, theirs)
        tasks = sorted(c[1] for c in shards.calls if c[0] == "task_done")
        assert tasks == list(range(-(-len(lengths) // shards.per)))

    def test_the_shm_coworker_packs_the_same_rows(self, tmp_path):
        """One coworker running chip_smoke's producer through the native
        ring gives the in-process packer's first STEPS rows."""
        from dlrover_tpu_torch.trainer.shm_dataloader import ShmDataLoader

        cs = _chip_smoke()
        path = str(tmp_path / "corpus.txt")
        cs.write_packed_corpus(path)
        rows = list(cs.packed_reader(path)[0])
        producer = cs.PackedRowsProducer(path, cs.STEPS)
        _same_batches(list(producer(0, 1)), rows[:cs.STEPS])
        loader = ShmDataLoader(producer, num_workers=1, slot_bytes=1 << 20,
                               n_slots=4, timeout=60.0)
        try:
            got = list(loader)
        finally:
            assert loader.shutdown(timeout=60.0)
        _same_batches(got, rows[:cs.STEPS])
