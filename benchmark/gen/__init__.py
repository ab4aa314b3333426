"""The benchmark's input generators (frozen: later changes to the program
do not move them)."""
