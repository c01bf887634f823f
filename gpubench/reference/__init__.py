"""The plain reference: a float32 decoder, constraint sets from the catalog,
beam search and the comparison.  It imports nothing of the program."""
