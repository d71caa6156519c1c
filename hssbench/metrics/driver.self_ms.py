"""driver.self_ms: the public call's self time a call, in ms: the root
`sort` span's stream time less its children's (the upload of host keys,
encode, pad, decode, count stripping and the policies' own work)."""
from hssbench.spans import self_ms


def read(r):
    return self_ms(r, "sort")
