"""maps_per_s: depth maps completed over the whole window, every map of
every forward issued in it, over the window's length up to the moment the
device finished the last."""


def read(obs):
    if not obs.units or not obs.window_s:
        return None
    return obs.units / obs.window_s
