"""The window's milliseconds over the optimiser steps it completed."""


def read(o):
    if "steps" not in o.window:
        return None
    return 1e3 * o.window["seconds"] / o.window["steps"]
