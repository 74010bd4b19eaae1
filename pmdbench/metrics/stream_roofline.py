"""The streaming layer against the host link: the movie's bytes in its own
dtype, once per call, at the published PCIe Gen5 x16 rate of one
direction, over the calls' wall time, in %. The work is counted once,
however often the program moves it."""


def read(run):
    calls = run.get("calls")
    if not calls or run["traffic"].get("movie_on") != "host":
        return None
    bound = run["movie"]["nbytes"] / run["peaks"]["pcie_gen5_x16_bytes_per_s"]
    return 100.0 * bound * len(calls) / sum(c["wall_s"] for c in calls)
