"""Multi-process data-parallel calling on torch.distributed: the port of
gatk_tpu/parallel/multihost.py.

The reference distributes reads over a Spark cluster
(engine/spark/GATKSparkTool.java:76,535,720-724; SparkSharder.java:39-56 shards
coordinate-sorted data by interval). Here, as in gatk_tpu, distribution is the
WDL scatter-gather collapsed into one launch of N processes:

  * every process calls `initialize()`, which joins a gloo process group whose
    TCP store process 0 hosts (gatk_tpu's jax.distributed coordinator is
    process 0 too);
  * the target intervals are split into `num_processes` shards
    (`shard_targets`), and each process calls only its own shard on its local
    devices: no traffic between processes while calling, interval padding is
    the halo exchange;
  * each process writes `<out>.shard-<pid>`; then either a barrier and
    process 0 concatenates the shard files on a shared mount
    (`gather_vcf_shards`), or the shard bytes are all-gathered over the group
    and process 0 writes them (`gather_vcf_shards_collective`, no shared
    filesystem) - the GatherVcfsCloud pattern (tools/GatherVcfsCloud.java).

The group is gloo, on the host: the barrier and the gather carry host bytes,
and two processes may share one card, where NCCL refuses two ranks.
mesh.bqsr_histogram_step reduces over whatever group is up (see its module).

Determinism: the shard plan depends only on (targets, num_processes), and each
region's result only on its padded interval's reads, so the gathered output of
N processes is the output of one, byte for byte.
"""
from __future__ import annotations

import os
import threading
from datetime import timedelta

import torch
import torch.distributed as dist

from .scheduler import split_interval_shards

# how long a process waits for a missing peer, at the rendezvous and in each
# collective (the gather waits for the slowest shard), before it fails
TIMEOUT = timedelta(minutes=30)

def initialize(coordinator_address: str, num_processes: int, process_id: int,
               local_device_ids=None):
    """Join the gloo group of `num_processes` processes at
    tcp://coordinator_address (host:port, served by process 0), waiting at most
    TIMEOUT for the others. local_device_ids is accepted for gatk_tpu's
    signature; a process calls on every local CUDA device
    (scheduler.cuda_devices) or, with --device cpu, on the host."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=TIMEOUT)


def start_initialize(coordinator_address: str, num_processes: int, process_id: int):
    """`initialize` in a thread, so that the rendezvous overlaps host work.
    Returns join(), which waits for it and raises what it raised."""
    failed = []

    def run():
        try:
            initialize(coordinator_address, num_processes, process_id)
        except Exception as e:  # raised again by join(), in the caller's thread
            failed.append(e)

    thread = threading.Thread(target=run, name="gatk-distributed-init", daemon=True)
    thread.start()

    def join():
        thread.join()
        if failed:
            raise RuntimeError(f"joining the process group at {coordinator_address} "
                               f"failed: {failed[0]}") from failed[0]

    return join


def shutdown():
    """Leave the process group (after the gather)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier(name: str = "gatk_tpu_torch"):
    """Global cross-process barrier (every process reaches this point)."""
    dist.barrier()


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def shard_targets(targets, num_processes: int | None = None,
                  process_id: int | None = None, mode: str = "contiguous"):
    """This process's bp-balanced target shard.

    When the target list is already fine-grained (>= num_processes targets,
    e.g. via --shard-size), WHOLE targets are assigned so every process plans
    regions over exactly the same interval boundaries a 1-process run would
    (exact output equality): `contiguous` runs (the GatherVcfsCloud-friendly
    layout) or `round-robin` interleaving (SparkSharder-style fine-grained
    load balancing - work hotspots spread across processes). Otherwise targets
    are bp-split (split_interval_shards). The defaults are the group's size
    and this process's rank (1 and 0 without a group)."""
    world, rank = _world()
    n = world if num_processes is None else num_processes
    pid = rank if process_id is None else process_id
    targets = list(targets)
    if mode == "round-robin" and len(targets) >= n:
        return targets[pid::n]
    if len(targets) >= n:
        total = sum(t.end - t.start for t in targets)
        shards, cur, acc = [], [], 0
        remaining = total
        for i, t in enumerate(targets):
            cur.append(t)
            acc += t.end - t.start
            remaining -= t.end - t.start
            slots_left = n - len(shards)
            # close the shard once it reaches its fair share, keeping at least
            # one target per remaining slot
            if len(shards) < n - 1 and acc * slots_left >= remaining + acc and \
                    len(targets) - i - 1 >= slots_left - 1:
                shards.append(cur)
                cur, acc = [], 0
        shards.append(cur)
        while len(shards) < n:
            shards.append([])
        return shards[pid]
    shards = split_interval_shards(targets, n)
    return shards[pid] if pid < len(shards) else []


def shard_vcf_path(output: str, process_id: int) -> str:
    return f"{output}.shard-{process_id:05d}"


def _write_merged(output: str, shards, sort: bool):
    """Write the VCF shards (iterables of lines, in shard order) into `output`:
    the first shard's header, then every shard's records, concatenated or, with
    sort=True, ordered by the header's contig order and position."""
    header_lines = []
    records = []
    with open(output, "w") as out:
        wrote_header = False
        for lines in shards:
            for line in lines:
                if line.startswith("#"):
                    if not wrote_header:
                        out.write(line)
                        header_lines.append(line)
                    continue
                if sort:
                    records.append(line)
                else:
                    out.write(line)
            wrote_header = True
        if sort:
            contig_order = {}
            for h in header_lines:
                if h.startswith("##contig=<ID="):
                    name = h.split("ID=")[1].split(",")[0].split(">")[0]
                    contig_order[name] = len(contig_order)
            records.sort(key=lambda l: (
                contig_order.get(l.split("\t", 1)[0], 1 << 30),
                int(l.split("\t", 2)[1])))
            out.writelines(records)


def _shard_file_lines(path: str, keep: bool):
    with open(path) as f:
        yield from f
    if not keep:
        os.remove(path)


def gather_vcf_shards(output: str, num_processes: int, keep_shards: bool = False,
                      sort: bool = False):
    """Concatenate per-process shard VCFs (in shard order) into `output`.
    With contiguous sharding concatenation preserves coordinate order; pass
    sort=True for round-robin sharding (records re-sorted by the header's
    contig order + position before writing - the GatherVcfsCloud merge)."""
    paths = [shard_vcf_path(output, pid) for pid in range(num_processes)]
    _write_merged(output, (_shard_file_lines(p, keep_shards) for p in paths
                           if os.path.exists(p)), sort)


def gather_vcf_shards_collective(output: str, shard_path: str, sort: bool = False,
                                 keep_shards: bool = False):
    """Shared-filesystem-free gather: every process contributes its local shard
    VCF's bytes to an all_gather over the process group (its length first, then
    its bytes padded to the longest as a uint8 tensor), and process 0 writes
    the merged output locally.

    Every process calls this exactly once after finishing its shard (it is
    itself a barrier); shard files may live in per-process private directories
    and are removed unless keep_shards. For outputs up to the memory of
    process 0's host; for terabyte-scale cohort VCFs use gather_vcf_shards on a
    shared mount."""
    data = b""
    if shard_path and os.path.exists(shard_path):
        with open(shard_path, "rb") as fh:
            data = fh.read()
    world, rank = dist.get_world_size(), dist.get_rank()
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lens, torch.tensor([len(data)], dtype=torch.int64))
    lens = [int(n) for n in lens]
    buf = torch.zeros(max(1, max(lens)), dtype=torch.uint8)
    if data:
        buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(bufs, buf)
    if not keep_shards and shard_path and os.path.exists(shard_path):
        os.remove(shard_path)
    if rank != 0:
        return
    texts = [bufs[pid][:n].numpy().tobytes().decode() for pid, n in enumerate(lens) if n]
    _write_merged(output, (t.splitlines(keepends=True) for t in texts), sort)
