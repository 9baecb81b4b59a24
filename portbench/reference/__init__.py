"""The plain reference: sparse products and Krylov loops in plain PyTorch,
worked out from the generator's COO arrays alone.  It imports nothing of
the program under test."""
