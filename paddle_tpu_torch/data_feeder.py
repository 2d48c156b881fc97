"""DataFeeder (reference: python/paddle/fluid/data_feeder.py) — turns
minibatch rows into the feed dict. Port of ``paddle_tpu/data_feeder.py``,
whose policy it copies exactly: the reference builds LoDTensors; here a
ragged column becomes a padded array and explicit lengths.

* each ragged column's per-row lengths go under ``<name>@LEN`` whenever
  the program declares a var of that name, so models thread them into
  the length-aware sequence ops (the padded form of LoD metadata,
  reference: framework/lod_tensor.h:44);
* ragged time dims are padded up to power-of-two buckets (not the batch
  max), so 20 distinct batch shapes make a handful of engine cache
  entries (each one a CUDA graph capture on the card) instead of 20.
  Padding past the batch max is free because the lengths mark the valid
  region. ``bucket_seq=False`` pads to the exact max.
"""

import numpy as np

from paddle_tpu_torch.core.types import convert_dtype_to_np

LENGTH_SUFFIX = "@LEN"

_MIN_BUCKET = 8


def bucketed_length(n, min_bucket=_MIN_BUCKET):
    """Round n up to a power-of-two bucket, at least ``min_bucket``."""
    b = max(1, min_bucket)
    while b < n:
        b *= 2
    return b


class DataFeeder:
    def __init__(self, feed_list, place, program=None, bucket_seq=True):
        from paddle_tpu_torch.framework import default_main_program

        self.feed_names = []
        self.feed_vars = []
        self.program = program or default_main_program()
        self.bucket_seq = bucket_seq
        for v in feed_list:
            if isinstance(v, str):
                v = self.program.global_block().var(v)
            self.feed_vars.append(v)
            self.feed_names.append(v.name)
        self.place = place
        self._len_var_cache = {}

    def _has_length_var(self, name):
        # fixed per feed var; memoised (the block lookup is on the
        # per-batch path)
        if name not in self._len_var_cache:
            block = self.program.global_block()
            self._len_var_cache[name] = (
                block.desc.find_var_recursive(name + LENGTH_SUFFIX)
                is not None)
        return self._len_var_cache[name]

    def feed(self, iterable):
        """iterable: the rows of a batch, each a tuple matching feed_list.
        Each column converts to its var's declared dtype."""
        columns = list(zip(*iterable))
        out = {}
        for var, col in zip(self.feed_vars, columns):
            dtype = convert_dtype_to_np(var.dtype)
            arrs = [np.asarray(x, dtype=dtype) for x in col]
            ragged = len({a.shape for a in arrs}) != 1
            # a declared <name>@LEN var marks a sequence column even when
            # this batch happens to be uniform (B=1, say): its lengths
            # and bucketing still apply
            is_seq = ragged or self._has_length_var(var.name)
            if not is_seq:
                batch = np.stack(arrs)
            else:
                # a sequence: right-pad axis 0 to a bucketed length
                maxlen = max(a.shape[0] for a in arrs)
                if self.bucket_seq:
                    maxlen = bucketed_length(maxlen)
                trail = arrs[0].shape[1:]
                batch = np.zeros((len(arrs), maxlen) + trail, dtype=dtype)
                for i, a in enumerate(arrs):
                    batch[i, : a.shape[0]] = a
            shape = var.shape
            if (shape is not None and len(shape) == len(batch.shape) + 1
                    and shape[-1] == 1):
                # the declared shape has a trailing 1 (labels [N, 1])
                batch = batch[..., None]
            out[var.name] = batch
            if is_seq and self._has_length_var(var.name):
                out[var.name + LENGTH_SUFFIX] = np.asarray(
                    [a.shape[0] for a in arrs], dtype=np.int64)
        return out

    def feed_parallel(self, iterable, num_places=None):
        """One feed dict per place-sized chunk of each batch (ceil split:
        every row lands somewhere; trailing places with no rows are
        skipped, not fed empty batches)."""
        for item in iterable:
            if not item:
                continue  # an empty batch (a filtered-out bucket)
            fd = self.feed(item)
            n = num_places or 1
            rows = np.asarray(fd[self.feed_names[0]]).shape[0]
            per = -(-rows // n)
            for i in range(n):
                lo = i * per
                if lo >= rows:
                    break
                yield {k: np.asarray(v)[lo:lo + per] for k, v in fd.items()}

    def decorate_reader(self, reader, multi_devices=False,
                        num_places=None, drop_last=True,
                        prefetch=False, prefetch_depth=None):
        """Wrap a batch reader into one yielding feed dicts. With
        ``multi_devices`` and ``drop_last``, a batch that does not split
        into ``num_places`` equal chunks is dropped.

        ``prefetch=True`` stages the feed dicts onto the feeder's place
        through ``engine/pipeline.py``'s PrefetchingFeeder: the
        conversion and the copy of batch k+1 (pinned buffer, side stream
        on the card) overlap step k on a background thread, at most
        ``prefetch_depth`` ahead (default: the ``prefetch_depth``
        flag)."""

        def __reader_creator__():
            if not multi_devices:
                for item in reader():
                    yield self.feed(item)
                return
            n = num_places or 1
            for item in reader():
                chunks = list(self.feed_parallel([item], num_places))
                if not chunks:
                    continue
                sizes = [np.asarray(c[self.feed_names[0]]).shape[0]
                         for c in chunks]
                uniform = (len(chunks) == n
                           and all(s == sizes[0] for s in sizes))
                if drop_last and not uniform:
                    continue
                for d in chunks:
                    yield d

        if prefetch:
            from paddle_tpu_torch.engine.pipeline import prefetch_to_device

            return prefetch_to_device(__reader_creator__,
                                      depth=prefetch_depth,
                                      device=self.place.torch_device())
        return __reader_creator__
