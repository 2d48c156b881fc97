"""Data-entry layers (reference: python/paddle/fluid/layers/io.py — data:39,
py_reader:636, double_buffer:1005, Preprocessor:1082). Port of
``paddle_tpu/layers/io.py``.

``py_reader`` declares feed vars and registers a ``PyReader`` on the
program: a producer thread pickles each batch's numpy arrays into the
native ``BlockingQueue``, and ``Executor.run`` with no ``feed=`` pops the
next batch, raising ``EOFException`` at the end of the epoch. The other
reader layers are Python readers under the reference's layer names: the
reference's C++ reader ops have no graph form here.
"""

import contextlib
import pickle
import threading

import numpy as np

from paddle_tpu_torch import unique_name
from paddle_tpu_torch.core.types import VarType, convert_dtype_to_np
from paddle_tpu_torch.framework import (
    Program,
    default_main_program,
    program_guard,
)
from paddle_tpu_torch.native import BlockingQueue


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True,
         stop_gradient=True, type=VarType.LOD_TENSOR):
    """Declare a feed variable. With ``append_batch_size`` a -1 batch dim
    is prepended, exactly like the reference."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().current_block()
    if name in block.vars:
        return block.vars[name]
    return block.create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        lod_level=lod_level,
        stop_gradient=stop_gradient,
        type=type,
    )


class PyReader:
    """Decoupled feeding: a background thread converts each batch of the
    decorated reader to its vars' dtypes and pushes it, pickled, into the
    native blocking queue (``capacity`` batches: backpressure on the
    reader); ``Executor.run`` with no feed pops the next batch for this
    program."""

    def __init__(self, feed_vars, capacity):
        self.vars = list(feed_vars)
        self.var_names = [v.name for v in self.vars]
        self._dtypes = [convert_dtype_to_np(v.dtype) for v in self.vars]
        self._queue = BlockingQueue(capacity=capacity)
        self._thread = None
        self._reader = None
        self._exhausted = False

    def decorate_paddle_reader(self, reader):
        """``reader()`` yields one tuple a batch, aligned with the
        declared vars."""
        self._reader = reader

    decorate_batch_generator = decorate_paddle_reader
    decorate_sample_list_generator = decorate_paddle_reader

    def start(self):
        """Begin an epoch: a new producer thread over ``reader()``."""
        if self._reader is None:
            raise RuntimeError("decorate a reader before start()")
        if self._thread is not None and self._thread.is_alive():
            self.reset()
        self._queue.reset()
        self._exhausted = False
        queue, reader, dtypes = self._queue, self._reader, self._dtypes

        def producer():
            try:
                for batch in reader():
                    arrays = [np.asarray(x, dtype=dt)
                              for x, dt in zip(batch, dtypes)]
                    if not queue.push(pickle.dumps(arrays, protocol=4)):
                        return
            finally:
                queue.close()

        self._thread = threading.Thread(target=producer,
                                        name="paddle-gpu-py-reader",
                                        daemon=True)
        self._thread.start()

    def next_feed(self):
        """dict name -> array, or None when the epoch is exhausted."""
        item = self._queue.pop()
        if item is None:
            self._exhausted = True
            return None
        return dict(zip(self.var_names, pickle.loads(item)))

    def reset(self):
        """Stop the epoch: the queue's close releases a producer parked on
        a full queue, which then ends; what was queued is dropped."""
        self._queue.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self._queue.reset()


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Declare one feed var a slot (no batch dim is prepended: ``shapes``
    carry it) and register a PyReader over them on the main program.
    Returns the PyReader; its ``.vars`` are the program's inputs."""
    program = default_main_program()
    feed_vars = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        vname = unique_name.generate("%s_slot_%d" % (name or "py_reader", i))
        feed_vars.append(data(name=vname, shape=list(shape), dtype=dtype,
                              append_batch_size=False))
    reader = PyReader(feed_vars, capacity)
    if not hasattr(program, "_py_readers"):
        program._py_readers = []
    program._py_readers.append(reader)
    return reader


def double_buffer(reader, place=None, name=None):
    """The reader itself: PyReader's queue already reads ahead."""
    return reader


def batch(reader, batch_size):
    """The batching decorator (``reader.decorator.batch``) under the
    reference's layer name."""
    from paddle_tpu_torch.reader.decorator import batch as _batch

    return _batch(reader, batch_size)


def shuffle(reader, buffer_size):
    """The shuffling decorator (``reader.decorator.shuffle``) under the
    reference's layer name."""
    from paddle_tpu_torch.reader.decorator import shuffle as _shuffle

    return _shuffle(reader, buffer_size)


def open_files(filenames, shapes=None, lod_levels=None, dtypes=None,
               thread_num=None, buffer_size=None, pass_num=1,
               is_test=None):
    """A Python reader over RecordIO files, read by the native reader,
    ``pass_num`` times. Each record comes out as raw bytes, or, with
    ``shapes`` and ``dtypes``, parsed as one flat array after another of
    those shapes and dtypes (the layout ``recordio_writer`` writes). Pair
    it with ``batch`` and a ``py_reader`` or a ``DataFeeder``."""
    from paddle_tpu_torch import recordio

    if isinstance(filenames, str):
        filenames = [filenames]
    if bool(shapes) != bool(dtypes):
        raise ValueError(
            "open_files: give BOTH shapes and dtypes (to parse records "
            "into arrays) or NEITHER (raw bytes)")
    layout = [(int(np.prod(s)), tuple(s), np.dtype(d))
              for s, d in zip(shapes or (), dtypes or ())]

    def reader():
        for _ in range(pass_num):
            for fname in filenames:
                with recordio.Reader(fname) as records:
                    for rec in records:
                        if not layout:
                            yield rec
                            continue
                        out, off = [], 0
                        for n, shape, dtype in layout:
                            arr = np.frombuffer(rec, dtype=dtype, count=n,
                                                offset=off).reshape(shape)
                            off += arr.nbytes
                            out.append(arr)
                        yield tuple(out)

    return reader


def read_file(reader):
    """There is no in-graph file op: feed the reader of ``open_files``
    through a ``py_reader`` or a ``DataFeeder``."""
    raise NotImplementedError(
        "read_file consumed the C++ reader ops; use the returned python "
        "reader with fluid.DataFeeder or fluid.layers.py_reader "
        "(see open_files docstring)")


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """A py_reader whose slots copy the shapes and dtypes of existing data
    vars."""
    shapes = [list(v.shape) for v in feed_list]
    dtypes = [str(convert_dtype_to_np(v.dtype)) for v in feed_list]
    return py_reader(capacity=capacity, shapes=shapes, dtypes=dtypes,
                     name=name, use_double_buffer=use_double_buffer)


def random_data_generator(low, high, shapes, lod_levels=None,
                          for_parallel=True):
    """An endless reader of float32 tuples, uniform in [low, high), a
    fresh unseeded stream each time it starts."""

    def reader():
        rng = np.random.RandomState()
        while True:
            yield tuple(rng.uniform(low, high, s).astype(np.float32)
                        for s in shapes)

    return reader


class Preprocessor:
    """Per-batch preprocessing written as a program (reference:
    layers/io.py:1082 create_custom_reader/Preprocessor)::

        p = fluid.layers.Preprocessor(reader=my_py_reader)
        with p.block():
            img, lbl = p.inputs()
            p.outputs(img / 2, lbl + 1)
        new_reader = p()          # a reader of transformed tuples

    ``reader`` is a batch reader (a callable yielding tuples) or a
    PyReader; ``shapes``/``dtypes`` describe its slots (a PyReader carries
    its own). The block is its own Program, run on ``place``: by default
    the executor's default place, the card (the JAX package runs it on
    the CPU; pass ``fluid.CPUPlace()`` for that).
    """

    BEFORE_SUB_BLOCK = 0
    IN_SUB_BLOCK = 1
    AFTER_SUB_BLOCK = 2

    def __init__(self, reader, name=None, shapes=None, dtypes=None,
                 place=None):
        self.underlying_reader = reader
        self.name = name or unique_name.generate("create_custom_reader")
        self.shapes = shapes
        self.dtypes = dtypes
        self.place = place
        if shapes is None and hasattr(reader, "vars"):
            self.shapes = [list(v.shape) for v in reader.vars]
            self.dtypes = [str(convert_dtype_to_np(v.dtype))
                           for v in reader.vars]
        self.sub_program = None
        self.source_vars = None
        self.sink_var_names = None
        self.status = Preprocessor.BEFORE_SUB_BLOCK

    def _is_completed(self):
        return (self.sub_program is not None and self.source_vars
                and self.sink_var_names)

    def block(self):
        @contextlib.contextmanager
        def guard():
            self.status = Preprocessor.IN_SUB_BLOCK
            self.sub_program = Program()
            self._startup = Program()
            with program_guard(self.sub_program, self._startup):
                yield
            self.status = Preprocessor.AFTER_SUB_BLOCK
            if not self._is_completed():
                raise RuntimeError(
                    "The definition of preprocessor is incomplete! Set "
                    "input and output variables via 'inputs' and "
                    "'outputs' inside the sub-block.")

        return guard()

    def inputs(self):
        if self.status != Preprocessor.IN_SUB_BLOCK:
            raise RuntimeError(
                "Preprocessor.inputs() can only be invoked inside the "
                "sub-block.")
        if self.shapes is None or self.dtypes is None:
            raise ValueError(
                "Preprocessor needs BOTH shapes and dtypes (or a "
                "PyReader) to declare its sub-block inputs")
        self.source_vars = [
            data(name=unique_name.generate("preprocessor_source"),
                 shape=list(shape), dtype=dtype, append_batch_size=False)
            for shape, dtype in zip(self.shapes, self.dtypes)
        ]
        return self.source_vars

    def outputs(self, *outs):
        if self.status != Preprocessor.IN_SUB_BLOCK:
            raise RuntimeError(
                "Preprocessor.outputs() can only be invoked inside the "
                "sub-block.")
        self.sink_var_names = [v.name for v in outs]

    def __call__(self, *args, **kwargs):
        if self.status != Preprocessor.AFTER_SUB_BLOCK:
            raise RuntimeError(
                "Preprocessor output can only be retrieved after the "
                "sub-block is defined.")
        from paddle_tpu_torch.executor import Executor

        exe = Executor(self.place)
        program = self.sub_program
        startup = self._startup
        src_names = [v.name for v in self.source_vars]
        sinks = list(self.sink_var_names)
        reader = self.underlying_reader

        def batches():
            if isinstance(reader, PyReader):
                # a PyReader pumps dicts keyed by its own var names;
                # they map positionally onto the sub-block's sources
                reader.start()
                while True:
                    fd = reader.next_feed()
                    if fd is None:
                        return
                    yield [fd[n] for n in reader.var_names]
            else:
                for b in (reader() if callable(reader) else reader):
                    yield b

        def transformed():
            # parameters made inside block() live in its startup program
            exe.run(startup)
            for b in batches():
                yield tuple(exe.run(program, feed=dict(zip(src_names, b)),
                                    fetch_list=sinks))

        return transformed
