"""Multi-process bring-up: the reference's machine-list handshake mapped
onto torch.distributed.

Counterpart of lightgbm_tpu/parallel/distributed.py (reference:
src/network/linkers_socket.cpp Linkers::Construct and
include/LightGBM/network.h).  Every process calls
``dist.init_process_group`` with the TCP rendezvous of machine 0
(``tcp://host0:port0``), the world size ``num_machines`` and its rank
from the machine list; the tree learners then run their collectives over
that group (parallel/collectives.py).  The backend is NCCL when the rank
trains on the card and gloo with ``device_type=cpu``; the ``dist_backend``
parameter names another (gloo on the card: several ranks on one card,
which NCCL refuses).  Each rank trains on ``cuda:{rank % device_count}``.

Config mapping (reference: Config network params):
  machines / machine_list_filename : "host:port" entries, one per process;
    entry 0 is the rendezvous
  num_machines                     : process count (must match entries)
  local_listen_port                : tells apart processes on one host
  time_out (minutes)               : the process group's timeout

Rank detection is the JAX package's: the machine-list entry whose host is
a local address and whose port equals local_listen_port; the
LIGHTGBM_TPU_RANK environment variable overrides it.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import List, Tuple

import torch
import torch.distributed as dist

from ..utils.log import log_info, log_warning


def _parse_machines(cfg) -> List[Tuple[str, int]]:
    raw = cfg.machines
    if not raw and cfg.machine_list_filename:
        lines = []
        with open(cfg.machine_list_filename) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                # reference format: "host port"
                lines.append(":".join(line.split()))
        raw = ",".join(lines)
    out = []
    for entry in raw.replace("\n", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        host, _, port = entry.partition(":")
        out.append((host, int(port) if port else cfg.local_listen_port))
    return out


def _local_addresses() -> set:
    names = {"localhost", "127.0.0.1", socket.gethostname()}
    try:
        names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    return names


def detect_rank(cfg, machines: List[Tuple[str, int]]) -> int:
    env = os.environ.get("LIGHTGBM_TPU_RANK")
    if env is not None:
        return int(env)
    local = _local_addresses()
    for i, (host, port) in enumerate(machines):
        if host in local and port == cfg.local_listen_port:
            return i
    host_matches = [i for i, (host, _) in enumerate(machines) if host in local]
    if len(host_matches) == 1:
        return host_matches[0]
    if len(host_matches) > 1:
        raise ValueError(
            f"{len(host_matches)} machine-list entries match this host but "
            f"none matches local_listen_port={cfg.local_listen_port}; set "
            "local_listen_port per process or LIGHTGBM_TPU_RANK")
    raise ValueError(
        "cannot determine this machine's rank: no machine-list entry matches "
        f"a local address ({sorted(local)}); set LIGHTGBM_TPU_RANK")


def backend_for(cfg) -> str:
    """NCCL on the card, gloo on the CPU, unless ``dist_backend`` says."""
    name = str(cfg.extra.get("dist_backend", "") or "").strip().lower()
    if name:
        if name not in ("nccl", "gloo"):
            raise ValueError(f"dist_backend must be nccl or gloo, got {name!r}")
        return name
    return "gloo" if cfg.device_type == "cpu" else "nccl"


def init_distributed(cfg) -> bool:
    """Bring up the process group from the reference's network params.
    Returns True when a group of more than one rank is (already) up; a
    no-op for num_machines <= 1.  A fast rendezvous failure (rank 0 not
    listening yet) is retried a bounded number of times
    (LGBMTPU_INIT_RETRIES, default 3); a configuration error never is."""
    if cfg.num_machines <= 1:
        return False
    if dist.is_initialized():
        if dist.get_world_size() != cfg.num_machines:
            raise ValueError(f"a process group of {dist.get_world_size()} ranks "
                             f"is up, num_machines={cfg.num_machines}")
        return True
    machines = _parse_machines(cfg)
    if len(machines) != cfg.num_machines:
        raise ValueError(f"num_machines={cfg.num_machines} but the machine list "
                         f"has {len(machines)} entries")
    rank = detect_rank(cfg, machines)
    backend = backend_for(cfg)
    if backend == "nccl" or cfg.device_type != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("distributed training on the card needs CUDA; "
                               "pass device_type=cpu to train on the host")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    host0, port0 = machines[0]
    timeout = datetime.timedelta(minutes=max(int(cfg.time_out), 1))
    log_info(f"Initializing torch.distributed ({backend}): rank {rank}/"
             f"{cfg.num_machines}, rendezvous {host0}:{port0}")
    attempts = max(int(os.environ.get("LGBMTPU_INIT_RETRIES", "3")), 1)
    for attempt in range(attempts):
        t0 = time.monotonic()
        try:
            dist.init_process_group(backend, init_method=f"tcp://{host0}:{port0}",
                                    world_size=cfg.num_machines, rank=rank,
                                    timeout=timeout)
            break
        except (ValueError, TypeError):
            raise
        except Exception as e:  # noqa: BLE001 - the last attempt re-raises
            # only a FAST failure (the rendezvous not listening yet) is
            # worth retrying; one that used much of the timeout is not
            elapsed = time.monotonic() - t0
            if attempt == attempts - 1 or elapsed >= 0.5 * timeout.total_seconds():
                raise
            delay = min(1.0 * (2 ** attempt), 15.0)
            log_warning(f"distributed init attempt {attempt + 1}/{attempts} "
                        f"failed after {elapsed:.1f}s ({type(e).__name__}: "
                        f"{str(e)[:200]}); retrying in {delay:.1f}s")
            time.sleep(delay)
    return True


def free_network() -> None:
    """Tear the process group down (reference: LGBM_NetworkFree)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
