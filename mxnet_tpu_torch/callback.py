"""Training callbacks (counterpart of mxnet_tpu/callback.py):
``do_checkpoint`` and ``module_checkpoint`` epoch callbacks, the
``Speedometer`` throughput logger, ``ProgressBar``, ``log_train_metric``,
``LogValidationMetricsCallback``. Their closure signatures, file names
(``%s-%04d.params``) and log-line formats are the JAX package's and the
reference's, which log parsers match.
"""
from __future__ import annotations

import logging
import math
import sys
import time

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar", "LogValidationMetricsCallback"]


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False,
                      manager=None):
    """Checkpoint the Module (and optionally its optimizer states) every
    ``period`` epochs as ``prefix-NNNN.params`` (+ ``.states``). The JAX
    package's fault-tolerant ``manager`` is not ported (ROADMAP queue 1
    item 14) and is refused."""
    if manager is not None:
        from .base import MXNetError
        raise MXNetError("module_checkpoint(manager=...) is not ported yet "
                         "(ROADMAP queue 1 item 14)")
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Checkpoint params every `period` epochs (callback.py:55)."""
    from .model import save_checkpoint
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()
    return _callback


class Speedometer:
    """Logs samples/sec and metrics every `frequent` batches
    (callback.py:120)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg, param.epoch, count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                                 param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """ASCII progress bar over total batch count."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = math.ceil(100.0 * count / float(self.total))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        sys.stdout.write(f"[{prog_bar}] {percents}%\r")


class LogValidationMetricsCallback:
    def __call__(self, param):
        if not param.eval_metric:
            return
        name_value = param.eval_metric.get_name_value()
        for name, value in name_value:
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
