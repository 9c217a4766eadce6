"""Frames of every training step of the window over the window's seconds
(the window ends at a synchronize())."""


def read(obs):
    if obs.mode != "train" or obs.window_s <= 0:
        return None
    return obs.frames_done() / obs.window_s
