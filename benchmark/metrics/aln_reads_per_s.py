"""Reads taken from FASTQ to .sai by `aln`, a second: the reads of the
shards that ended inside the window over the time from the window's start
to the last of those ends."""


def read(view):
    return view.rate()
