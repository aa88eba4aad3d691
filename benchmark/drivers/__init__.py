"""One driver per traffic kind (`train`, `codec`): set-up of the program
under test, the measured window, and the comparison with the reference."""
