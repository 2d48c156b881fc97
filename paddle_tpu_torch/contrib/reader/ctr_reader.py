"""CTR data reader (reference:
python/paddle/fluid/contrib/reader/ctr_reader.py ctr_reader:66 — a C++
threaded reader over svm/csv slot files). Port of
``paddle_tpu/contrib/reader/ctr_reader.py``: a PyReader whose producer
thread parses the same formats, line by line in Python, as the JAX
package does (the MultiSlotDataFeed format has its own native parser,
``native.open_multislot_file``).

svm line format:  ``label slot_id:feasign slot_id:feasign ...``
csv line format:  ``label,dense...,sparse...`` per dense/sparse index.
"""

import numpy as np

__all__ = ["ctr_reader"]


def _parse_svm(line, slots):
    parts = line.strip().split()
    label = int(parts[0])
    by_slot = {s: [] for s in slots}
    for tok in parts[1:]:
        sid, feasign = tok.split(":")
        if sid in by_slot:
            by_slot[sid].append(int(feasign))
    return label, by_slot


def ctr_reader(feed_dict, file_type, file_format, dense_slot_index,
               sparse_slot_index, capacity, thread_num, batch_size,
               file_list, slots, name=None):
    """Returns a PyReader-style object whose ``next_feed`` yields parsed
    CTR batches (reference returns the C++ ctr reader variable)."""
    from paddle_tpu_torch.layers.io import PyReader

    if file_type not in ("svm", "csv"):
        raise ValueError("file_type must be 'svm' or 'csv'")

    def batch_reader():
        batch = []
        for path in file_list:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if file_type == "svm":
                        label, by_slot = _parse_svm(line, slots)
                        row = [np.asarray([label], np.int64)] + [
                            np.asarray(by_slot[s] or [0], np.int64)
                            for s in slots
                        ]
                    else:
                        parts = line.split(",")
                        label = int(parts[0])
                        dense = [float(parts[1 + i])
                                 for i in dense_slot_index]
                        sparse = [int(parts[1 + i])
                                  for i in sparse_slot_index]
                        row = [np.asarray([label], np.int64),
                               np.asarray(dense, np.float32),
                               np.asarray(sparse, np.int64)]
                    batch.append(row)
                    if len(batch) == batch_size:
                        yield _stack(batch)
                        batch = []
        if batch:
            yield _stack(batch)

    def _stack(rows):
        n = len(rows[0])
        out = []
        for i in range(n):
            arrs = [r[i] for r in rows]
            width = max(a.shape[0] for a in arrs)
            padded = np.zeros((len(arrs), width), arrs[0].dtype)
            for j, a in enumerate(arrs):
                padded[j, :a.shape[0]] = a
            out.append(padded)
        return tuple(out)

    reader = PyReader(list(feed_dict.values()) if feed_dict else [],
                      capacity)
    reader.decorate_paddle_reader(batch_reader)
    return reader
