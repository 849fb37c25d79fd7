"""Text-file readers fed by a shard source (port of
``dlrover_tpu/trainer/text_reader.py``): the reader maps record indices
to fixed-shape token batches, so the shard source stays on the
per-shard path and the device sees static shapes only.

- ``LineIndexedFile``: one pass builds a byte-offset index; thereafter
  any index range is a seek and a read, so workers can consume shards in
  any order (faster workers take more shards).
- ``ByteTokenizer``: a byte-level tokenizer with no vocabulary file
  (ids 2-257 for the bytes, 0 pad, 1 bos); ``HFTokenizerAdapter`` puts
  a HuggingFace tokenizer in its place.
- ``ShardedTextBatches``: fetch a shard, render ``[B, S]`` batches
  (padded, or packed: documents concatenated into full rows with
  segment ids), report batch and task completion. The client is any
  object with ``fetch_shard()`` (a shard with ``start``, ``end`` and
  ``record_indices``, or None at the end), ``current_task_id``,
  ``report_batch_done()``, ``report_task_done()`` and
  ``report_task_done_by_id(task_id)``, as the reference's
  ``ShardingClient`` has them.

It imports numpy and no torch, so a spawned coworker that packs rows
starts without it.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("trainer.text")


class LineIndexedFile:
    """Random access to a text file by line index."""

    def __init__(self, path: str):
        self.path = path
        # start offset of each line; Python's line iteration never yields
        # a phantom record for a trailing newline
        self._starts: List[int] = []
        offset = 0
        with open(path, "rb") as f:
            for line in f:
                self._starts.append(offset)
                offset += len(line)
        self._size = offset

    def count(self) -> int:
        """Number of records (reference: ``FileReader.count_data``)."""
        return len(self._starts)

    def _read_range_into(self, f, start: int, end: int,
                         out: List[bytes]) -> None:
        f.seek(self._starts[start])
        for i in range(start, end):
            upper = (self._starts[i + 1] if i + 1 < self.count()
                     else self._size)
            raw = f.read(upper - self._starts[i])
            out.append(raw.rstrip(b"\r\n"))

    def read_range(self, start: int, end: int) -> List[bytes]:
        """Records in [start, end) (reference:
        ``read_data_by_index_range``)."""
        end = min(end, self.count())
        if start >= end:
            return []
        out: List[bytes] = []
        with open(self.path, "rb") as f:
            self._read_range_into(f, start, end, out)
        return out

    def read_indices(self, indices: List[int]) -> List[bytes]:
        """Records at arbitrary indices, in the given order (shuffled
        shards carry an explicit permutation). One open for the whole
        call; contiguous runs share one seek — a fully shuffled shard is
        seeks, not open/close pairs (which dominate on network fs)."""
        out: List[bytes] = []
        dropped = 0
        with open(self.path, "rb") as f:
            i = 0
            while i < len(indices):
                j = i
                while j + 1 < len(indices) and \
                        indices[j + 1] == indices[j] + 1:
                    j += 1
                if indices[i] < self.count():
                    upper = min(indices[j] + 1, self.count())
                    dropped += indices[j] + 1 - upper
                    self._read_range_into(f, indices[i], upper, out)
                else:
                    dropped += j + 1 - i
                i = j + 1
        if dropped:
            # the sharding protocol still credits these records as
            # consumed (report_batch_done counts batch_size regardless),
            # so a master/reader dataset_size mismatch would otherwise
            # shrink the epoch with no signal at all
            logger.warning(
                "%s: dropped %d out-of-range record indices (max index "
                "%d >= %d records) — the master's dataset_size "
                "over-declares this file",
                self.path, dropped, max(indices), self.count(),
            )
        return out


class ByteTokenizer:
    """Byte-level ids in [2, 257]; 0 = pad, 1 = bos. Fixed length."""

    vocab_size = 258

    def __init__(self, seq_len: int):
        self.seq_len = seq_len

    def __call__(self, record: bytes) -> np.ndarray:
        ids = np.frombuffer(record[: self.seq_len - 1], np.uint8)
        out = np.zeros((self.seq_len,), np.int32)
        out[0] = 1  # bos
        out[1:1 + len(ids)] = ids.astype(np.int32) + 2
        return out

    def encode(self, record: bytes) -> np.ndarray:
        """Variable-length encoding (bos + bytes), for the packing path."""
        ids = np.frombuffer(record, np.uint8).astype(np.int32) + 2
        return np.concatenate([np.asarray([1], np.int32), ids])


class HFTokenizerAdapter:
    """Plug a HuggingFace tokenizer (``transformers`` PreTrained* or a
    raw ``tokenizers.Tokenizer``) into the shard-fed batch source: maps
    its encode onto the fixed-shape ``__call__`` (padded mode) and the
    variable-length ``encode`` (packed mode) this pipeline expects.
    ``ByteTokenizer`` remains the zero-dependency default; this is the
    production-vocabulary path."""

    def __init__(self, tokenizer, seq_len: int,
                 pad_id: int = 0, bos_id: Optional[int] = None,
                 eos_id: Optional[int] = None):
        self._tok = tokenizer
        self.seq_len = seq_len
        self.pad_id = pad_id
        self.bos_id = bos_id
        # with eos_id set, every document gets a terminal EOS appended;
        # ``_render`` additionally knows (via this attribute) to keep the
        # end-of-text prediction target alive under the pad == eos
        # convention, where the terminal EOS is otherwise folded into
        # the trailing pad run by the position-based mask
        self.eos_id = eos_id
        size = getattr(tokenizer, "vocab_size", None)
        if size is None and hasattr(tokenizer, "get_vocab_size"):
            size = tokenizer.get_vocab_size()
        self.vocab_size = int(size)

    def _ids(self, record: bytes) -> List[int]:
        text = record.decode("utf-8", errors="replace")
        try:
            # transformers tokenizers inject their own specials by
            # default (duplicated BOS, [CLS]/[SEP] in every record) —
            # this pipeline owns special-token placement
            encoded = self._tok.encode(text, add_special_tokens=False)
        except TypeError:  # raw `tokenizers.Tokenizer`: no such kwarg
            encoded = self._tok.encode(text)
        ids = encoded if isinstance(encoded, list) else encoded.ids
        ids = list(ids)
        if self.bos_id is not None:
            ids = [self.bos_id] + ids
        if self.eos_id is not None:
            ids = ids + [self.eos_id]
        return ids

    def encode(self, record: bytes) -> np.ndarray:
        return np.asarray(self._ids(record), np.int32)

    def __call__(self, record: bytes) -> np.ndarray:
        ids = self._ids(record)[: self.seq_len]
        out = np.full((self.seq_len,), self.pad_id, np.int32)
        out[: len(ids)] = ids
        return out


class ShardedTextBatches:
    """Dynamic-shard consumption loop over a line-indexed text file.

    Yields ``{"input_ids": [B, S], "labels": [B, S]}`` numpy batches
    (labels = inputs shifted left, pad masked to -100). The master hands
    out index shards; batch rendering happens worker-side, so the master
    is never on the per-batch path.
    """

    def __init__(
        self,
        sharding_client,
        reader: LineIndexedFile,
        batch_size: int,
        tokenizer: Optional[Callable[[bytes], np.ndarray]] = None,
        seq_len: int = 128,
        pack: bool = False,
    ):
        self._client = sharding_client
        self._reader = reader
        self._batch = batch_size
        self._seq_len = seq_len
        self._tok = tokenizer or ByteTokenizer(seq_len)
        self._pack = pack
        if pack and not hasattr(self._tok, "encode"):
            raise ValueError(
                "pack=True needs a tokenizer with an .encode(bytes) -> "
                "variable-length id array method (fixed-length __call__ "
                "tokenizers cannot pack); ByteTokenizer provides one"
            )
        # packing state: documents spill across shard fetches
        self._pack_rows: List[dict] = []
        self._cur_ids: List[int] = []
        self._cur_segs: List[int] = []
        self._next_seg = 0
        self._rows_finished = 0  # rows ever completed by _finish_row
        self._rows_consumed = 0  # rows ever emitted in yielded batches
        # (task_id, row mark): the shard may be reported done only once
        # every row holding its tokens has been YIELDED — reporting at
        # pack time would let the master mark records consumed that a
        # worker crash would lose from the in-memory buffer
        self._pending_tasks: List[Tuple[int, int]] = []

    def _render(self, records: List[bytes]) -> dict:
        ids = np.stack([self._tok(r) for r in records])
        labels = np.full_like(ids, -100)
        labels[:, :-1] = ids[:, 1:]
        # mask pad by POSITION (the trailing pad run), not by token id —
        # masking every occurrence of the id would silently untrain real
        # tokens sharing it (the common pad == eos convention)
        pad_id = getattr(self._tok, "pad_id", 0)
        not_pad = ids != pad_id
        has_any = not_pad.any(axis=1)
        lengths = np.where(
            has_any, ids.shape[1] - np.argmax(not_pad[:, ::-1], axis=1), 0
        )
        eos_id = getattr(self._tok, "eos_id", None)
        if eos_id is not None and eos_id == pad_id:
            # pad == eos convention with a known eos: the document's
            # terminal EOS shares the pad id, so the position scan folds
            # it into the trailing pad run — count exactly one trailing
            # token as the real EOS so the model still gets an
            # end-of-text prediction target. (Tokenizers without an
            # eos_id keep the conservative mask: the terminal-EOS target
            # is the residual gap, documented here on purpose.)
            lengths = np.where(
                has_any & (lengths < ids.shape[1]), lengths + 1, lengths
            )
        # labels[t] predicts ids[t+1]: valid only while t+1 < length
        t = np.arange(ids.shape[1])[None, :]
        labels[t >= lengths[:, None] - 1] = -100
        return {"input_ids": ids, "labels": labels}

    # -- packed mode --------------------------------------------------------

    def _finish_row(self):
        s = self._seq_len
        ids = np.zeros((s,), np.int32)
        segs = np.full((s,), -1, np.int32)  # -1 = pad segment
        n = len(self._cur_ids)
        ids[:n] = self._cur_ids
        segs[:n] = self._cur_segs
        labels = np.full((s,), -100, np.int32)
        # next-token WITHIN a segment only: no target across document
        # boundaries or into pad
        labels[:-1] = ids[1:]
        boundary = segs[:-1] != segs[1:]
        labels[:-1][boundary] = -100
        labels[-1] = -100
        labels[segs == -1] = -100
        self._pack_rows.append(
            {"input_ids": ids, "segment_ids": segs, "labels": labels})
        self._cur_ids, self._cur_segs = [], []
        self._rows_finished += 1

    def _pack_records(self, records: List[bytes]):
        """Greedy fill: a document that doesn't fit the remainder is
        split; the continuation gets a fresh segment id (attention can't
        span rows, so the split IS a truncation boundary)."""
        s = self._seq_len
        for rec in records:
            encoded = self._tok.encode(rec)
            offset = 0
            while offset < len(encoded):
                room = s - len(self._cur_ids)
                if room == 0:
                    self._finish_row()
                    room = s
                take = encoded[offset:offset + room]
                seg = self._next_seg
                self._next_seg += 1
                self._cur_ids.extend(take.tolist())
                self._cur_segs.extend([seg] * len(take))
                offset += len(take)
            if len(self._cur_ids) == s:
                self._finish_row()

    def _drain_packed_batches(self, flush: bool = False):
        if flush and self._cur_ids:
            self._finish_row()
        while len(self._pack_rows) >= self._batch or (
            flush and self._pack_rows
        ):
            rows = self._pack_rows[: self._batch]
            del self._pack_rows[: len(rows)]
            self._rows_consumed += len(rows)
            while len(rows) < self._batch:
                # flush tail: repeat the last row for a static shape,
                # with labels masked — a packed row is a full dense
                # seq_len of tokens, so an unmasked copy would weight
                # its gradient batch-fill times
                filler = dict(rows[-1])
                filler["labels"] = np.full_like(filler["labels"], -100)
                rows.append(filler)
            yield {
                key: np.stack([r[key] for r in rows])
                for key in ("input_ids", "segment_ids", "labels")
            }
            # NB: no report_batch_done here. The master credits that rpc
            # in SOURCE RECORDS and auto-completes a shard when credits
            # reach its size (batch_dataset_manager.report_batch_done) —
            # packed rows are not records, so crediting them would pop
            # the task out of 'doing' while its tokens still sit in this
            # buffer, silently bypassing the deferred completion below.
            self._report_emitted_tasks()

    def _report_emitted_tasks(self, flush: bool = False):
        """Complete shards whose every row has been yielded (or all of
        them at flush, when the buffers are empty by construction)."""
        remaining = []
        for task_id, mark in self._pending_tasks:
            if flush or mark <= self._rows_consumed:
                self._client.report_task_done_by_id(task_id)
            else:
                remaining.append((task_id, mark))
        self._pending_tasks = remaining

    def __iter__(self) -> Iterator[dict]:
        while True:
            shard = self._client.fetch_shard()
            if shard is None:
                if self._pack:
                    yield from self._drain_packed_batches(flush=True)
                    self._report_emitted_tasks(flush=True)
                return
            if getattr(shard, "record_indices", None):
                # shuffled datasets: the shard carries an explicit
                # permutation; honour it, or "shuffle=True" would train
                # on contiguous ranges
                records = self._reader.read_indices(
                    list(shard.record_indices))
            else:
                records = self._reader.read_range(shard.start, shard.end)
            if self._pack:
                self._pack_records(records)
                task_id = self._client.current_task_id
                if task_id is not None:
                    # completion deferred until this shard's rows (incl.
                    # the still-open partial row) have been YIELDED
                    mark = self._rows_finished + (
                        1 if self._cur_ids else 0)
                    self._pending_tasks.append((task_id, mark))
                yield from self._drain_packed_batches()
                continue
            for lo in range(0, len(records), self._batch):
                chunk = records[lo:lo + self._batch]
                n_real = len(chunk)
                if n_real < self._batch:
                    # pad the tail batch to a static shape by repeating
                    # the last record,
                    # with the copies' labels masked, or the repeated
                    # record would train at (batch - n_real + 1)x weight
                    chunk = chunk + [chunk[-1]] * (self._batch - n_real)
                batch = self._render(chunk)
                if n_real < self._batch:
                    batch["labels"][n_real:] = -100
                yield batch
                self._client.report_batch_done()
            self._client.report_task_done()
