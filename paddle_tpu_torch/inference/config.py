"""``inference.Config`` (``paddle_tpu/inference/config.py``): the model
location and the runtime switches.

A Config runs on the card (``gpu:<gpu_device_id>``) unless
``disable_gpu()`` is called. The graph switches (``ir_optim``,
``memory_optim``) are recorded and reported by ``summary()``: the loaded
program runs its ATen operators and the port's kernels as exported.
"""
from __future__ import annotations

import os
from typing import Optional

__all__ = ["Config"]


class Config:
    def __init__(self, model_dir: Optional[str] = None,
                 params_file: Optional[str] = None):
        # (prog, params) two-arg form mirrors the reference ctor overload
        self._model_dir = None
        self._prog_file = None
        self._params_file = None
        if model_dir is not None and params_file is not None:
            self.set_prog_file(model_dir)
            self._params_file = params_file
        elif model_dir is not None:
            self.set_model(model_dir)
        self._device = "gpu"
        self._device_id = 0
        self._ir_optim = True
        self._memory_optim = True
        self._cpu_math_threads = 1
        self._profile = False
        self._glog_info = True

    # -- model location ------------------------------------------------------
    def set_model(self, model: str, params_file: Optional[str] = None) -> None:
        """``model`` is either a directory holding one jit.save artifact or
        a path prefix (the reference's combined-model form)."""
        if params_file is not None:
            self.set_prog_file(model)
            self._params_file = params_file
            return
        if os.path.isdir(model):
            self._model_dir = model
            # clear every earlier location form; model_prefix() prefers
            # _prefix/_prog_file, so stale ones would win over this dir
            self._prefix = None
            self._prog_file = None
            self._params_file = None
        else:
            self._model_dir = None
            self._prog_file = None
            self._params_file = None
            # path prefix: jit.save wrote <prefix>.pdmodel/<prefix>.pdiparams
            self._prefix = model

    def set_prog_file(self, path: str) -> None:
        self._prog_file = path

    def set_params_file(self, path: str) -> None:
        self._params_file = path

    def model_dir(self) -> Optional[str]:
        return self._model_dir

    def prog_file(self) -> Optional[str]:
        return self._prog_file

    def params_file(self) -> Optional[str]:
        return self._params_file

    def model_prefix(self) -> Optional[str]:
        """Resolve the jit.save path prefix this config points at."""
        if getattr(self, "_prefix", None):
            return self._prefix
        if self._prog_file:
            p = self._prog_file
            return p[:-len(".pdmodel")] if p.endswith(".pdmodel") else p
        if self._model_dir:
            cands = [f[:-len(".pdmodel")] for f in os.listdir(self._model_dir)
                     if f.endswith(".pdmodel")]
            if len(cands) != 1:
                raise ValueError(
                    f"model_dir {self._model_dir!r} must hold exactly one "
                    f".pdmodel artifact, found {sorted(cands)}")
            return os.path.join(self._model_dir, cands[0])
        return None

    # -- device --------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb: int = 100,
                       device_id: int = 0) -> None:
        """Run on card ``device_id`` (the pool size is the caching
        allocator's business and is ignored)."""
        self._device = "gpu"
        self._device_id = device_id

    def enable_tpu(self, device_id: int = 0) -> None:
        """The JAX package's name for the accelerator: the card here."""
        self.enable_use_gpu(device_id=device_id)

    def disable_gpu(self) -> None:
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device == "gpu"

    def device(self) -> str:
        """The torch device name the predictor runs on."""
        return f"cuda:{self._device_id}" if self.use_gpu() else "cpu"

    def gpu_device_id(self) -> int:
        return self._device_id

    # -- switches ------------------------------------------------------------
    def switch_ir_optim(self, flag: bool = True) -> None:
        self._ir_optim = bool(flag)

    def ir_optim(self) -> bool:
        return self._ir_optim

    def enable_memory_optim(self, flag: bool = True) -> None:
        self._memory_optim = bool(flag)

    def memory_optim_enabled(self) -> bool:
        return self._memory_optim

    def set_cpu_math_library_num_threads(self, n: int) -> None:
        self._cpu_math_threads = int(n)

    def cpu_math_library_num_threads(self) -> int:
        return self._cpu_math_threads

    def enable_profile(self) -> None:
        self._profile = True

    def disable_glog_info(self) -> None:
        self._glog_info = False

    def glog_info_disabled(self) -> bool:
        return not self._glog_info

    def summary(self) -> str:
        rows = [
            ("model_prefix", str(self.model_prefix())),
            ("device", f"{self._device}:{self._device_id}"),
            ("ir_optim", str(self._ir_optim)),
            ("memory_optim", str(self._memory_optim)),
            ("cpu_math_threads", str(self._cpu_math_threads)),
        ]
        width = max(len(k) for k, _ in rows)
        return "\n".join(f"{k.ljust(width)}  {v}" for k, v in rows)
