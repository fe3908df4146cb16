"""The benchmark's plain reference: the paper's mixture and SD-KDE in
float64.  Imports torch and numpy only, nothing of the program."""
