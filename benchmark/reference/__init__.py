"""The plain reference the check holds the program to: no import of the program."""
