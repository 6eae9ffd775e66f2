"""Training of the port (the copy of ``repro.train``): step factories and
the fault-tolerant loop."""

from .steps import (TrainState, batch_specs, cache_logical_specs,  # noqa
                    init_train_state, make_decode_step, make_prefill_step,
                    make_train_step)
