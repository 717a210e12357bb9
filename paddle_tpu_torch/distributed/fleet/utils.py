"""fleet.utils — filesystem abstraction, logging, hybrid-parallel helpers
(``paddle_tpu/distributed/fleet/utils.py``).

Reference parity: ``python/paddle/distributed/fleet/utils/`` — ``fs.py``
(FS/LocalFS/HDFSClient), ``log_util.py`` (rank-prefixed logger), and
``hybrid_parallel_util.py`` (broadcast_mp_parameters :198,
broadcast_dp_parameters :206, fused_allreduce_gradients :226). On the
port's processes the helpers are real collectives, as the reference's:
``broadcast_mp_parameters`` / ``broadcast_dp_parameters`` broadcast
every parameter over that axis's group of the ``HybridCommunicateGroup``
(the one given, else fleet's, else the live mesh's axis) from the axis's
first rank, and do nothing with one rank on the axis or no process
group; ``fused_allreduce_gradients`` averages the gradients over ``dp``
in buckets (``DataParallel``'s: reverse parameter order, 1 MB then 25
MB, one all_reduce each, a divide, copies back in place), a no-op at one
rank. A collective that fails mid-list raises.
"""
from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sys
from typing import List, Optional

__all__ = [
    "ExecuteError", "FSFileExistsError", "FSFileNotExistsError", "FSTimeOut",
    "FS", "LocalFS", "HDFSClient", "get_logger", "logger",
    "broadcast_mp_parameters", "broadcast_dp_parameters",
    "fused_allreduce_gradients", "recompute", "UtilBase",
    "DistributedInfer",
]


class UtilBase:
    """Fleet utility facade (reference: fleet/base/util_factory.py:49 —
    all_reduce/barrier/all_gather over the worker world + file sharding).
    The collective methods delegate to the mesh collectives; comm_world
    selection ('worker'/'server'/'all') is a PS-era concept — the worker
    world IS the mesh here, and server-side reduction runs in the PS
    tables (distributed/ps)."""

    def __init__(self, role_maker=None):
        self.role_maker = role_maker

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        """Host-side reduce over the worker world (the reference runs
        this over gloo, not the training fabric): gather everyone's
        value, reduce locally."""
        import numpy as _np

        from .. import all_gather_object

        vals = []
        all_gather_object(vals, _np.asarray(input))
        fn = {"sum": _np.sum, "max": _np.max, "min": _np.min}[mode]
        return fn(_np.stack(vals), axis=0)

    def barrier(self, comm_world="worker"):
        from .. import barrier as _barrier

        _barrier()

    def all_gather(self, input, comm_world="worker"):
        from .. import all_gather_object

        out = []
        all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        """Contiguous near-even split of `files` for this worker
        (reference: util_factory.py:232)."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file need to be"
                            " read.")
        if self.role_maker is not None:
            trainer_id = self.role_maker._worker_index()
            trainers = self.role_maker._worker_num()
        else:
            from .. import get_rank, get_world_size

            trainer_id, trainers = get_rank(), max(get_world_size(), 1)
        remainder = len(files) % trainers
        blocksize = len(files) // trainers
        blocks = [blocksize + (1 if i < remainder else 0)
                  for i in range(trainers)]
        start = sum(blocks[:trainer_id])
        return files[start:start + blocks[trainer_id]]

    def print_on_rank(self, message, rank_id):
        from .. import get_rank

        if get_rank() == rank_id:
            print(message, flush=True)


class DistributedInfer:
    """PS-mode distributed inference helper (reference:
    fleet/utils/ps_util.py DistributedInfer — pulls the sparse
    parameters from the servers before running inference). Here sparse
    params live in the native PS tables; ``init_distributed_infer_env``
    triggers a pull into the local model and ``get_dist_infer_program``
    returns the (unchanged) program — XLA owns program rewriting."""

    def __init__(self, main_program=None, startup_program=None):
        self._main_program = main_program

    def init_distributed_infer_env(self, exe=None, loss=None,
                                   role_maker=None, dirname=None):
        # sparse params are pulled lazily by SparseEmbedding's forward
        # (distributed/ps/layers.py) — nothing to prefetch eagerly
        return None

    def get_dist_infer_program(self):
        return self._main_program


# ------------------------------------------------------------------ fs


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FS:
    """Abstract filesystem (reference: fs.py:51)."""

    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False):
        raise NotImplementedError

    def list_dirs(self, fs_path):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError

    def cat(self, fs_path):
        raise NotImplementedError


class LocalFS(FS):
    """Local filesystem client (reference: fs.py:113)."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path)
        elif self.is_file(fs_path):
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if exist_ok:
                return
            raise FSFileExistsError(fs_path)
        with open(fs_path, "a"):
            pass

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        if self.is_exist(dst_path):
            raise FSFileExistsError(dst_path)
        shutil.move(src_path, dst_path)

    def upload(self, local_path, fs_path):
        # local "upload" is a copy (reference behavior)
        if self.is_dir(local_path):
            shutil.copytree(local_path, fs_path)
        else:
            shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        self.upload(fs_path, local_path)

    def cat(self, fs_path):
        with open(fs_path) as f:
            return f.read()


class HDFSClient(FS):
    """HDFS via the ``hadoop fs`` CLI (reference: fs.py HDFSClient — same
    shell-out contract; raises ExecuteError when the binary is absent)."""

    def __init__(self, hadoop_home: Optional[str] = None, configs=None,
                 time_out: int = 5 * 60 * 1000, sleep_inter: int = 1000):
        self._hadoop = os.path.join(hadoop_home, "bin/hadoop") \
            if hadoop_home else "hadoop"
        self._configs = []
        for k, v in (configs or {}).items():
            self._configs += ["-D", f"{k}={v}"]
        self._timeout = time_out / 1000.0

    def _run(self, *args) -> str:
        cmd = [self._hadoop, "fs", *self._configs, *args]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=self._timeout)
        except FileNotFoundError as e:
            raise ExecuteError(
                f"hadoop binary not found ({self._hadoop}); set "
                "hadoop_home") from e
        except subprocess.TimeoutExpired as e:
            raise FSTimeOut(" ".join(cmd)) from e
        if proc.returncode != 0:
            raise ExecuteError(f"{' '.join(cmd)}: {proc.stderr.strip()}")
        return proc.stdout

    def is_exist(self, fs_path):
        try:
            self._run("-test", "-e", fs_path)
            return True
        except ExecuteError:
            return False

    def is_dir(self, fs_path):
        try:
            self._run("-test", "-d", fs_path)
            return True
        except ExecuteError:
            return False

    def is_file(self, fs_path):
        return self.is_exist(fs_path) and not self.is_dir(fs_path)

    def ls_dir(self, fs_path):
        out = self._run("-ls", fs_path)
        dirs, files = [], []
        for line in out.splitlines():
            parts = line.split()
            if len(parts) < 8:
                continue
            name = os.path.basename(parts[-1])
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def list_dirs(self, fs_path):
        return self.ls_dir(fs_path)[0]

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        self._run("-rm", "-r", "-skipTrash", fs_path)

    def rename(self, src, dst):
        self._run("-mv", src, dst)

    mv = rename

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path) and not exist_ok:
            raise FSFileExistsError(fs_path)
        self._run("-touchz", fs_path)

    def cat(self, fs_path):
        return self._run("-cat", fs_path)

    def need_upload_download(self):
        return True


# ------------------------------------------------------------------ logging


def get_logger(log_level=logging.INFO, name: str = "FleetLog") -> logging.Logger:
    """Rank-prefixed logger (reference: log_util.py)."""
    lg = logging.getLogger(name)
    if not lg.handlers:
        handler = logging.StreamHandler(sys.stderr)
        rank = os.environ.get("PADDLE_TRAINER_ID", "0")
        handler.setFormatter(logging.Formatter(
            f"[rank {rank}] %(asctime)s %(levelname)s %(message)s"))
        lg.addHandler(handler)
        lg.propagate = False
    lg.setLevel(log_level)
    return lg


logger = get_logger()


# ------------------------------------------- hybrid-parallel param helpers


_AXIS_GROUP = {"dp": "get_data_parallel_group",
               "mp": "get_model_parallel_group"}


def _axis_group(axis: str, hcg):
    """The group of ``axis`` (module docstring), or None when there is
    no process group or one rank on the axis."""
    import torch.distributed as tdist

    from .. import topology

    if not tdist.is_initialized():
        return None
    if hcg is None:
        from . import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
    if hcg is not None:
        group = getattr(hcg, _AXIS_GROUP[axis])()
    else:
        mesh = topology.get_mesh()
        if mesh is None or axis not in mesh.axis_names:
            return None
        group = mesh.group(axis)
    return group if group.nranks > 1 else None


def _sync_params_over_axis(model, axis: str, hcg) -> None:
    """Every rank of the axis's group takes its first rank's parameter
    values."""
    from .. import collective

    group = _axis_group(axis, hcg)
    if group is None:
        return
    for p in model.parameters():
        collective.broadcast(getattr(p, "_value", p), src=group.ranks[0],
                             group=group)


def broadcast_mp_parameters(model, hcg=None) -> None:
    """reference: hybrid_parallel_util.py:198."""
    _sync_params_over_axis(model, "mp", hcg)


def broadcast_dp_parameters(model, hcg=None) -> None:
    """reference: hybrid_parallel_util.py:206."""
    _sync_params_over_axis(model, "dp", hcg)


def fused_allreduce_gradients(parameter_list: List, hcg=None) -> None:
    """Mean-reduce grads across the dp axis (reference:
    hybrid_parallel_util.py:226 — fused allreduce of all grads), in
    ``DataParallel``'s buckets (module docstring); a no-op with one rank
    on ``dp``."""
    import torch

    from .. import collective
    from ..parallel import _buckets

    group = _axis_group("dp", hcg)
    if group is None:
        return
    grads = [getattr(p, "_value", p).grad for p in parameter_list]
    grads = [g for g in grads if g is not None]
    pg, n, _ = collective._resolve(group)
    mb = 1024 * 1024
    with torch.no_grad():
        for bucket in _buckets(grads, (1 * mb, 25 * mb)):
            flat = torch.cat([grads[i].reshape(-1) for i in bucket])
            collective._all_reduce_into(flat, "sum", pg, n)
            flat.div_(n)
            off = 0
            for i in bucket:
                k = grads[i].numel()
                grads[i].copy_(flat[off:off + k].view_as(grads[i]))
                off += k


# recompute is re-exported here because fleet.utils.recompute is the
# reference's import path for it
from .recompute import recompute  # noqa: E402,F401
