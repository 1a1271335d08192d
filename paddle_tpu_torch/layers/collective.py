"""Collective layer wrappers — the port of
``paddle_tpu/layers/collective.py`` (the reference's
``fluid/layers/collective.py``): each appends one ``c_*`` op
(``ops/collective.py``)."""
from __future__ import annotations

from ..framework.layer_helper import LayerHelper


def _c_allreduce(x, out=None, reduce_type="sum", ring_id=0,
                 use_calc_stream=False):
    helper = LayerHelper("c_allreduce_" + reduce_type)
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="c_allreduce_" + reduce_type,
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"ring_id": ring_id, "use_calc_stream": use_calc_stream},
    )
    return out


def _c_allgather(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_allgather")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="c_allgather",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"nranks": nranks, "ring_id": ring_id,
               "use_calc_stream": use_calc_stream},
    )
    return out


def _c_reducescatter(x, nranks, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_reducescatter")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="c_reducescatter",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"nranks": nranks, "ring_id": ring_id,
               "use_calc_stream": use_calc_stream},
    )
    return out


def _c_broadcast(x, root=0, ring_id=0, use_calc_stream=False):
    helper = LayerHelper("c_broadcast")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="c_broadcast",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"root": root, "ring_id": ring_id,
               "use_calc_stream": use_calc_stream},
    )
    return out


def _c_sync_calc_stream(x):
    return x


def _c_sync_comm_stream(x, ring_id=0):
    return x


def barrier(ring_id=0):
    helper = LayerHelper("barrier")
    helper.append_op(type="barrier", attrs={"ring_id": ring_id})
