"""The largest peak of device memory allocated over the window by any
rank of a sharded cell (torch.cuda.max_memory_allocated on each rank's
card after the warm pass reset it), GiB, from the traffic's `work()`;
`peak_gib` reads rank 0's alone."""


def read(rec):
    ranks = rec.work.get("ranks")
    if not ranks:
        return None
    return max(r["peak_bytes"] for r in ranks) / 2**30
