"""Model code: configs -> parameters -> the decode forward."""
