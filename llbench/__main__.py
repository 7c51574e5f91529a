"""python3 -m llbench --workload CELL --seed N --seconds S --trace 0|1"""
from .run import main

if __name__ == "__main__":
    main()
