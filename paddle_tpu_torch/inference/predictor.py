"""Predictor serving API (ref: inference/api/analysis_predictor.cc,
paddle_api.h PaddlePredictor; paddle_tpu/inference/predictor.py:19-167).

load -> run: the directory written by `io.save_inference_model` (by either
package; parameters one file each or, with `params_file`, in one file) or
by the reference's own save_inference_model (a protobuf `__model__`,
inference/ref_format.py; detected by its first byte unless
`Config.ref_format` says which) is loaded into the predictor's own Scope on
its device, and each `run` interprets the pruned program with the
Executor; `run_batches` runs K batches through `Executor.run_steps`. The
predictor runs on the card unless the Config asks for the CPU with
`disable_gpu()`.
"""
from __future__ import annotations

import os

from ..core.scope import Scope, scope_guard
from ..executor import Executor
from ..framework import CPUPlace, CUDAPlace


class Config(object):
    """AnalysisConfig equivalent: where the model lives and where it runs
    (CUDAPlace(0) unless disable_gpu() is called)."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self.ref_format = None   # None = autodetect, True/False to force
        self._place = CUDAPlace(0)

    def set_model(self, model_dir, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file

    def disable_gpu(self):
        self._place = CPUPlace()
        return self


class Predictor(object):
    def __init__(self, config):
        self._config = config
        self._scope = Scope()
        self._exe = Executor(config._place)
        self._program, self._feed_names, self._fetch_vars = self._load()

    def _load(self):
        from .. import io as ptt_io
        from . import ref_format
        cfg = self._config
        ref = cfg.ref_format
        if ref is None:
            # the JSON program of save_inference_model starts with '{';
            # the reference's protobuf ProgramDesc does not
            path = os.path.join(cfg.model_dir, cfg.prog_file or '__model__')
            with open(path, 'rb') as f:
                ref = f.read(1) != b'{'
        if ref:
            return ref_format.load_reference_inference_model(
                cfg.model_dir, self._exe, model_filename=cfg.prog_file,
                params_filename=cfg.params_file, scope=self._scope)
        with scope_guard(self._scope):
            return ptt_io.load_inference_model(
                cfg.model_dir, self._exe, model_filename=cfg.prog_file,
                params_filename=cfg.params_file)

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v.name for v in self._fetch_vars]

    def _feed(self, inputs):
        if isinstance(inputs, (list, tuple)):
            if len(inputs) != len(self._feed_names):
                raise ValueError(
                    "predictor expects %d inputs (%s), got %d"
                    % (len(self._feed_names), self._feed_names, len(inputs)))
            inputs = dict(zip(self._feed_names, inputs))
        return dict(inputs)

    def run(self, inputs, return_numpy=True):
        """inputs: a list in feed order or a dict name -> array/tensor.
        Returns the outputs as numpy arrays, or as device tensors with
        return_numpy=False (an async serving loop then syncs once)."""
        return self._exe.run(self._program, feed=self._feed(inputs),
                             fetch_list=self.get_output_names(),
                             scope=self._scope, return_numpy=return_numpy)

    def run_batches(self, batches, return_numpy=True):
        """Bulk inference over K batches, each a list (feed order) or dict
        as `run` takes it, through Executor.run_steps with
        fetch_policy='stack' (paddle_tpu/inference/predictor.py:116-146).
        Returns K per-batch output lists, each equal to a `run` of its
        batch; every batch must have the same shapes."""
        feeds = [self._feed(b) for b in batches]
        if not feeds:
            return []
        missing = [n for n in self._feed_names
                   if any(n not in f for f in feeds)]
        if missing:
            raise ValueError("batches missing feeds: %r (predictor "
                             "expects %s)" % (missing, self._feed_names))
        outs = self._exe.run_steps(
            self._program, feed={n: [f[n] for f in feeds]
                                 for n in self._feed_names},
            fetch_list=self.get_output_names(), scope=self._scope,
            fetch_policy='stack', return_numpy=return_numpy)
        return [[o[i] for o in outs] for i in range(len(feeds))]

    def warmup(self, sample_inputs):
        """One run ahead of serving (cuDNN picks its algorithms)."""
        self.run(sample_inputs)
        return self

    def clone(self):
        """A predictor sharing this one's weights and executor."""
        twin = Predictor.__new__(Predictor)
        twin.__dict__.update(self.__dict__)
        return twin


def create_predictor(config):
    return Predictor(config)
