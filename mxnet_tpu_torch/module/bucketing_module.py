"""``BucketingModule``: a Module per bucket key, sharing parameters.

Port of ``mxnet_tpu/module/bucketing_module.py`` (reference
``python/mxnet/module/bucketing_module.py``).  Each bucket key (a
sequence length) gets its own ``Module`` from ``sym_gen(key)``, bound
with the default bucket's parameter arrays (the same NDArrays), its
optimizer and its optimizer states, so a step in one bucket is seen by
every other.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._bind_args = None

    @property
    def symbol(self):
        return self._curr_module.symbol

    @property
    def data_shapes(self):
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        return self._curr_module.label_shapes

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, **kwargs):
        if self.binded and not force_rebind:
            return
        self._bind_args = dict(for_training=for_training,
                               inputs_need_grad=inputs_need_grad)
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False)
        self._buckets[self._default_bucket_key] = module
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True
        self.for_training = for_training

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("switch_bucket before bind")
        if bucket_key not in self._buckets:
            master = self._buckets[self._default_bucket_key]
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._bind_args["for_training"],
                        self._bind_args["inputs_need_grad"],
                        shared_module=master)
            if self.params_initialized:
                module.params_initialized = True
            if self.optimizer_initialized:
                # the optimizer and its states are shared, as the arrays
                module._optimizer = master._optimizer
                module._opt_states = master._opt_states
                module.optimizer_initialized = True
            self._buckets[bucket_key] = module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, *args, **kwargs):
        self._buckets[self._default_bucket_key].init_params(*args, **kwargs)
        for m in self._buckets.values():
            m.params_initialized = True
        self.params_initialized = True

    def init_optimizer(self, *args, **kwargs):
        master = self._buckets[self._default_bucket_key]
        master.init_optimizer(*args, **kwargs)
        for m in self._buckets.values():
            m._optimizer = master._optimizer
            m._opt_states = master._opt_states
            m.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = data_batch.bucket_key
        if key is None:
            key = self._curr_bucket_key
        data_shapes = [(d.name if hasattr(d, "name") else d[0],
                        tuple(d.shape if hasattr(d, "shape") else d[1]))
                       for d in (data_batch.provide_data or
                                 [("data", data_batch.data[0].shape)])]
        label_shapes = None
        if data_batch.label:
            label_shapes = [(d.name if hasattr(d, "name") else d[0],
                             tuple(d.shape if hasattr(d, "shape") else d[1]))
                            for d in (data_batch.provide_label or
                                      [("softmax_label",
                                        data_batch.label[0].shape)])]
        self.switch_bucket(key, data_shapes, label_shapes)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr_module.update_metric(eval_metric, labels)

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def switch_to_default(self):
        self._curr_module = self._buckets[self._default_bucket_key]
        self._curr_bucket_key = self._default_bucket_key
