"""GB (1e9 bytes) of the policy's constraint tables on the device
(``nbytes()`` of the trie or the stacked store)."""


def read(rec):
    return rec.index_bytes / 1e9 if rec.index_bytes else None
