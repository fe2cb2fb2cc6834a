"""View passes completed over the window's seconds, from its start to the
end of its last pass (host clock)."""


def read(window):
    return len(window.pass_s) / window.window_s
