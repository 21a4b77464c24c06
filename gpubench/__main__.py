from gpubench.run import main

if __name__ == "__main__":  # not in a process that multiprocessing spawns
    raise SystemExit(main())
