"""Seconds from the process's start to the window's first submit: imports,
inputs, the program's index and engine, kernel builds, warm-up rounds."""


def read(rec):
    return rec.setup_s
