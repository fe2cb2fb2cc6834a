"""Seconds from the start of the process to the start of the window: the
kernels' build (first run in a checkout only), the scene, the set-up's
passes and the warm passes."""


def read(window):
    return window.setup_s
