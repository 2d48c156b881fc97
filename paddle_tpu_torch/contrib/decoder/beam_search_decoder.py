"""High-level RNN decoder API — port of
``paddle_tpu/contrib/decoder/beam_search_decoder.py`` (reference:
python/paddle/fluid/contrib/decoder/beam_search_decoder.py — InitState:43,
StateCell:158, TrainingDecoder:384, BeamSearchDecoder:525), unchanged but
for its imports, so both packages build the same descs.

Same contract, padded-batch semantics: the reference grows/shrinks LoD
batches during beam search; here the beam layout is a fixed [batch*beam]
block and states follow beam reordering via an explicit parent-index
gather (the padded form of its sequence_expand over LoD). Two traits are
the JAX package's and are kept: the parents array is seeded with zeros,
not the identity (``elementwise_sub(flat_ids, flat_ids)``), and
``decode`` never sets ``first_step``, so beams of equal initial score
hold the same candidates and ``top_k``'s tie rule picks their parents.
The decode loop is a ``While``: its block runs eagerly on the card.
"""

import contextlib

from paddle_tpu_torch import layers
from paddle_tpu_torch.framework import Variable
from paddle_tpu_torch.layer_helper import LayerHelper

__all__ = ["InitState", "StateCell", "TrainingDecoder",
           "BeamSearchDecoder"]


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState:
    """Initial hidden state holder (reference: beam_search_decoder.py:43).
    Either wraps an existing variable or creates a constant one shaped
    like ``init_boot``."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "init_boot must be provided to infer the shape of "
                "InitState")
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value, shape=shape, dtype=dtype)
        self._need_reorder = need_reorder

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState:
    """A state living as a DynamicRNN memory (training decode)."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = self._rnn_obj.memory(init=init_state.value)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class _ArrayState:
    """A state living in a tensor array indexed by the decode counter
    (beam-search decode). The array and its step-0 init write live in the
    decoder's PARENT block (reference: _ArrayState writing via
    parent_block.append_op) — inside the While body they would re-run
    every iteration."""

    def __init__(self, state_name, decoder, init_state, counter, zero_idx):
        self._state_name = state_name
        self._counter = counter
        self._init = init_state.value
        with decoder._in_parent_block():
            self._array = layers.create_array(init_state.value.dtype)
            layers.array_write(init_state.value, zero_idx,
                               array=self._array)

    def get_state(self):
        read = layers.array_read(array=self._array, i=self._counter)
        # array reads have no static shape; layers like fc need one —
        # states keep the init's shape across steps
        if self._init.shape is not None:
            read.desc.shape = list(self._init.shape)
        return read

    def update_state(self, state):
        next_i = layers.increment(self._counter, value=1, in_place=False)
        layers.array_write(state, next_i, array=self._array)


class StateCell:
    """Named hidden states + step inputs of an RNN cell with a
    user-defined updater (reference: beam_search_decoder.py:158)."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper("state_cell", name=name)
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError("state must be an InitState object.")
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = inputs
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state
        if out_state not in self._cur_states:
            raise ValueError("out_state must be one state in states")

    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError("StateCell has already entered a decoder.")
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder:
            raise ValueError("StateCell not in decoder.")
        if self._cur_decoder_obj is not decoder_obj:
            raise ValueError("Inconsistent decoder object in StateCell.")
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False

    def _switch_decoder(self):
        if not self._in_decoder:
            raise ValueError("StateCell must enter a decoder.")
        if self._switched_decoder:
            raise ValueError("StateCell already done switching.")
        dec = self._cur_decoder_obj
        for state_name in self._state_names:
            if state_name not in self._states_holder:
                state = self._cur_states[state_name]
                if not isinstance(state, InitState):
                    raise ValueError(
                        "state %r should be an InitState" % state_name)
                self._states_holder[state_name] = {}
                if dec.type == _DecoderType.TRAINING:
                    holder = _MemoryState(state_name, dec.dynamic_rnn,
                                          state)
                elif dec.type == _DecoderType.BEAM_SEARCH:
                    holder = _ArrayState(state_name, dec, state,
                                         dec._counter, dec._zero_idx)
                else:
                    raise ValueError("Unknown decoder type")
                self._states_holder[state_name][id(dec)] = holder
            self._cur_states[state_name] = \
                self._states_holder[state_name][id(dec)].get_state()
        self._switched_decoder = True

    def get_state(self, state_name):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError("Unknown state %s" % state_name)
        return self._cur_states[state_name]

    def get_input(self, input_name):
        if input_name not in self._inputs or \
                self._inputs[input_name] is None:
            raise ValueError("Invalid input %s." % input_name)
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        """Decorator registering the per-step state update function."""
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is self:
                raise TypeError(
                    "Updater should only accept a StateCell object")
            updater(state_cell)

        return _decorator

    def compute_state(self, inputs):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError("Unknown input %s" % input_name)
            self._inputs[input_name] = input_value
        self._state_updater(self)

    def update_states(self):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for state_name, decoder_state in self._states_holder.items():
            if id(self._cur_decoder_obj) not in decoder_state:
                raise ValueError("Unknown decoder object")
            decoder_state[id(self._cur_decoder_obj)].update_state(
                self._cur_states[state_name])

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder:
    """Teacher-forced decoder over DynamicRNN (reference:
    beam_search_decoder.py:384)."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        self._helper = LayerHelper("training_decoder", name=name)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN()
        self._type = _DecoderType.TRAINING
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)

    @contextlib.contextmanager
    def block(self):
        if self._status != TrainingDecoder.BEFORE_DECODER:
            raise ValueError("decoder.block() can only be invoked once")
        self._status = TrainingDecoder.IN_DECODER
        with self._dynamic_rnn.block():
            yield
        self._status = TrainingDecoder.AFTER_DECODER
        self._state_cell._leave_decoder(self)

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def step_input(self, x, length=None, level=0):
        self._assert_in_decoder_block("step_input")
        return self._dynamic_rnn.step_input(x, length=length,
                                            level=level)

    def static_input(self, x):
        self._assert_in_decoder_block("static_input")
        return self._dynamic_rnn.static_input(x)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError(
                "Output of training decoder can only be visited outside "
                "the block.")
        return self._dynamic_rnn(*args, **kwargs)

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self._dynamic_rnn.output(*outputs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError(
                "%s should be invoked inside block of TrainingDecoder"
                % method)


class BeamSearchDecoder:
    """Beam-search inference decoder (reference:
    beam_search_decoder.py:525). The decode loop runs under While with a
    fixed [batch*beam] layout; states follow the beam via a parent-index
    gather each step instead of the reference's LoD sequence_expand."""

    BEFORE_BEAM_SEARCH_DECODER = 0
    IN_BEAM_SEARCH_DECODER = 1
    AFTER_BEAM_SEARCH_DECODER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._counter = layers.zeros(shape=[1], dtype="int64")
        self._counter.stop_gradient = True
        self._type = _DecoderType.BEAM_SEARCH
        self._max_len = layers.fill_constant(shape=[1], dtype="int64",
                                             value=max_len)
        self._cond = layers.less_than(x=self._counter, y=self._max_len)
        self._while_op = layers.While(self._cond)
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._status = BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER
        self._zero_idx = layers.fill_constant(shape=[1], value=0,
                                              dtype="int64")
        self._array_dict = {}
        self._array_link = []
        self._ids_array = None
        self._scores_array = None
        # parents array pre-seeded with identity (zeros) so the While
        # carry sees a fully-formed array at entry
        self._parents_array = layers.create_array("int64")
        flat_ids = layers.reshape(init_ids, shape=[-1])
        layers.array_write(
            layers.elementwise_sub(flat_ids, flat_ids), self._zero_idx,
            array=self._parents_array)
        self._beam_size = beam_size
        self._end_id = end_id
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._topk_size = topk_size
        self._sparse_emb = sparse_emb
        self._word_dim = word_dim
        self._input_var_dict = input_var_dict or {}

    @contextlib.contextmanager
    def block(self):
        if self._status != \
                BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER:
            raise ValueError("block() can only be invoked once.")
        self._status = BeamSearchDecoder.IN_BEAM_SEARCH_DECODER
        with self._while_op.block():
            yield
            with layers.Switch() as switch:
                with switch.case(self._cond):
                    layers.increment(x=self._counter, value=1,
                                     in_place=True)
                    for value, array in self._array_link:
                        layers.array_write(value, self._counter,
                                           array=array)
                    layers.less_than(x=self._counter, y=self._max_len,
                                     cond=self._cond)
        self._status = BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER
        self._state_cell._leave_decoder(self)

    @property
    def type(self):
        return self._type

    def early_stop(self):
        """Break out of the decode loop."""
        layers.fill_constant(shape=[1], value=0, dtype="bool",
                             out=self._cond)

    def decode(self):
        """The standard embed -> state update -> softmax -> beam step
        loop (override for custom decoders)."""
        with self.block():
            prev_ids = self.read_array(init=self._init_ids, is_ids=True)
            prev_scores = self.read_array(init=self._init_scores,
                                          is_scores=True)
            prev_ids_embedding = layers.embedding(
                input=prev_ids,
                size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb)

            feed_dict = {}
            update_dict = {}
            for init_var_name, init_var in self._input_var_dict.items():
                if init_var_name not in self.state_cell._inputs:
                    raise ValueError(
                        "Variable %s not found in StateCell"
                        % init_var_name)
                read_var = self.read_array(init=init_var)
                update_dict[init_var_name] = read_var
                feed_dict[init_var_name] = read_var

            for input_name in self._state_cell._inputs:
                if input_name not in feed_dict:
                    feed_dict[input_name] = prev_ids_embedding

            self.state_cell.compute_state(inputs=feed_dict)
            current_state = self.state_cell.out_state()
            scores = layers.fc(input=current_state,
                               size=self._target_dict_dim, act="softmax")
            topk_scores, topk_indices = layers.topk(
                scores, k=min(self._topk_size, self._target_dict_dim))
            accu_scores = layers.elementwise_add(
                x=layers.log(topk_scores),
                y=layers.reshape(prev_scores, shape=[-1, 1]), axis=0)
            selected_ids, selected_scores, parent_idx = \
                layers.beam_search(
                    prev_ids, prev_scores, topk_indices, accu_scores,
                    self._beam_size, end_id=self._end_id, level=0,
                    return_parent_idx=True)

            # beam reordering: gather every state by the parent index
            # (the padded-layout equivalent of sequence_expand by LoD)
            for state_str in self._state_cell._state_names:
                prev_state = self.state_cell.get_state(state_str)
                self._state_cell.set_state(
                    state_str,
                    layers.gather(prev_state,
                                  layers.reshape(parent_idx,
                                                 shape=[-1])))
            self.state_cell.update_states()
            self.update_array(prev_ids, selected_ids)
            self.update_array(prev_scores, selected_scores)
            self._record_parents(parent_idx)
            for update_name, var_to_update in update_dict.items():
                self.update_array(var_to_update, feed_dict[update_name])

    def _record_parents(self, parent_idx):
        self._array_link.append((parent_idx, self._parents_array))

    def read_array(self, init, is_ids=False, is_scores=False):
        self._assert_in_decoder_block("read_array")
        if is_ids and is_scores:
            raise ValueError(
                "An array cannot be both the ids and the scores array.")
        if not isinstance(init, Variable):
            raise TypeError("`init` must be a Variable.")
        with self._in_parent_block():
            array = layers.create_array(init.dtype)
            layers.array_write(init, self._zero_idx, array=array)
        if is_ids:
            self._ids_array = array
        elif is_scores:
            self._scores_array = array
        read_value = layers.array_read(array=array, i=self._counter)
        if init.shape is not None:
            read_value.desc.shape = list(init.shape)
        self._array_dict[read_value.name] = array
        return read_value

    def update_array(self, array, value):
        self._assert_in_decoder_block("update_array")
        if not isinstance(array, Variable):
            raise TypeError("`array` must be a Variable.")
        if not isinstance(value, Variable):
            raise TypeError("`value` must be a Variable.")
        arr = self._array_dict.get(array.name)
        if arr is None:
            raise ValueError("invoke read_array before update_array.")
        self._array_link.append((value, arr))

    def __call__(self):
        if self._status != \
                BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER:
            raise ValueError(
                "Output of BeamSearchDecoder can only be visited "
                "outside the block.")
        return layers.beam_search_decode(
            ids=self._ids_array, scores=self._scores_array,
            beam_size=self._beam_size, end_id=self._end_id,
            parent_array=self._parents_array)

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    @contextlib.contextmanager
    def _in_parent_block(self):
        """Temporarily build ops in the While's parent block (the
        reference's parent_block.append_op pattern)."""
        prog = self._helper.main_program
        cur = prog.current_block_idx
        parent = prog.current_block().parent_idx
        if parent < 0:
            parent = cur
        prog.current_block_idx = parent
        try:
            yield
        finally:
            prog.current_block_idx = cur

    def _assert_in_decoder_block(self, method):
        if self._status != BeamSearchDecoder.IN_BEAM_SEARCH_DECODER:
            raise ValueError(
                "%s should be invoked inside block of BeamSearchDecoder"
                % method)
