"""The host side of the checkpoint store's serialized tiers, measured on
the machine it runs on.

    python3 tools/io_probe.py            # a machine with a CUDA GPU, ~1 min

Rates that bound a commit and a resume of a large training state (a
mamba2-2.7b one is 16.2 GB): per candidate directory (``$TMPDIR`` or
``/tmp``, and ``/dev/shm``) its file system, free bytes, and the GB/s of
writing a 2 GiB file from one thread and from 8 threads (``os.pwritev``,
the store's writer) and of hashing it back through a private mapping
(the store's read path); blake2b over 64 KiB chunks on 1 and on 8 threads
(the store's encoder); device-to-host and host-to-device copies of 2 GiB
from pinned and from pageable memory; the host's memory.  One JSON line
each, beside the card's name and power limit.
"""
import hashlib
import json
import mmap
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N = 2 << 30                 # bytes per measurement
CHUNK = 1 << 16             # the store's chunk
PIECE = 1 << 26             # the store's pooled piece


def emit(obj):
    print(json.dumps(obj), flush=True)


def hash_range(view, start, stop):
    for off in range(start, stop, CHUNK):
        hashlib.blake2b(view[off:off + CHUNK], digest_size=16).hexdigest()


def hash_rate(view, threads):
    t0 = time.perf_counter()
    if threads == 1:
        hash_range(view, 0, len(view))
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(lambda o: hash_range(view, o, min(o + PIECE,
                                                            len(view))),
                          range(0, len(view), PIECE)))
    return len(view) / 1e9 / (time.perf_counter() - t0)


def write_rate(path, view, threads):
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)

    def put(off):
        done = 0
        piece = view[off:off + PIECE]
        while done < len(piece):
            done += os.pwritev(fd, [piece[done:]], off + done)
    t0 = time.perf_counter()
    if threads == 1:
        for off in range(0, len(view), PIECE):
            put(off)
    else:
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(put, range(0, len(view), PIECE)))
    os.close(fd)
    return len(view) / 1e9 / (time.perf_counter() - t0)


def copy_rate(dst, src):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    return N / 1e9 / (time.perf_counter() - t0)


def main():
    if not torch.cuda.is_available():
        sys.exit("io_probe: no CUDA device available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    meminfo = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":")
            meminfo[key] = int(val.split()[0]) * 1024
    emit({"card": smi, "cpus": os.cpu_count(),
          "host_memory_bytes": meminfo["MemTotal"],
          "host_memory_available_bytes": meminfo["MemAvailable"]})
    data = np.random.default_rng(0).integers(0, 255, N, dtype=np.uint8)
    view = memoryview(data)
    emit({"blake2b_64k_gb_per_s": {"1_thread": hash_rate(view, 1),
                                   "8_threads": hash_rate(view, 8)}})
    mounts = {}
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            mounts[parts[1]] = parts[2]
    for root in (tempfile.gettempdir(), "/dev/shm"):
        real = os.path.realpath(root)
        fs = mounts[max((m for m in mounts if (real + "/").startswith(
            m.rstrip("/") + "/")), key=len)]
        d = tempfile.mkdtemp(dir=real)
        path = os.path.join(d, "probe.bin")
        try:
            w1 = write_rate(path, view, 1)
            w8 = write_rate(path, view, 8)
            with open(path, "rb") as f:
                mapped = mmap.mmap(f.fileno(), N, access=mmap.ACCESS_COPY)
            r8 = hash_rate(memoryview(mapped), 8)
            mapped.close()
        finally:
            shutil.rmtree(d)
        emit({"directory": real, "filesystem": fs,
              "free_bytes": shutil.disk_usage(real).free,
              "write_gb_per_s": {"1_thread": w1, "8_threads": w8},
              "mapped_read_and_hash_8_threads_gb_per_s": r8})
    dev = torch.empty(N, dtype=torch.uint8, device="cuda").fill_(7)
    pinned = torch.empty(N, dtype=torch.uint8, pin_memory=True)
    pageable = torch.empty(N, dtype=torch.uint8)
    rates = {}
    for label, host in (("pinned", pinned), ("pageable", pageable)):
        copy_rate(host, dev)                              # warm
        rates[label] = {"device_to_host_gb_per_s": copy_rate(host, dev),
                        "host_to_device_gb_per_s": copy_rate(dev, host)}
    emit({"copies_2gib": rates, "card": smi})


if __name__ == "__main__":
    main()
