"""Set-up seconds: from the process's start to the window's start (imports,
kernel libraries from the build directory, weights, maps or corpus, the
warm-up and the captures), by the host clock."""


def read(record):
    return record.get("setup_s")
