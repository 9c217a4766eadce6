"""Atoms of every evaluation of the window over the window's seconds."""


def read(obs):
    if obs.mode != "eval" or obs.window_s <= 0:
        return None
    return obs.atoms_done() / obs.window_s
