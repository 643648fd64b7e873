"""The share of the traced training steps' window, in %, in which no
kernel, copy or set ran on the device."""


def read(obs: dict):
    traced, secs = obs.get('traced'), obs.get('traced_s')
    if not traced or not secs or traced['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - traced['busy_s'] / secs)
