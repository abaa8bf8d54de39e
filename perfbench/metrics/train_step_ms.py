"""train_step_ms: the whole window over all the training steps it ran."""


def read(obs):
    if not obs.units or not obs.window_s:
        return None
    return obs.window_s * 1e3 / obs.units
