"""The four-rank step's rate in the traced run: 16 pairs per completed global
step over the window's wall (rank 0's, after every rank synchronised), with
the program's recorder on in rank 0. The end-to-end rate of the same
quantity spreads too widely run to run on a shared host to bear a bound
(`PERF.md` §2), so it stands here, unbounded."""


def read(record):
    if not record.get("pairs") or not record.get("window_s"):
        return None
    return record["pairs"] / record["window_s"]
