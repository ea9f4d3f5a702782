"""Read pairs taken from two FASTQ files to SAM, a second: the pairs of the
shards that ended inside the window over the time from the window's start
to the last of those ends (a shard's units are its pairs)."""


def read(view):
    return view.rate()
