"""The frozen generators write the bytes of the program's generators."""

import numpy as np

from seedbench import gen


def test_frozen_generators_match_program_generators(tmp_path):
    from psi_tpu_torch.pathutil import sequence
    from psi_tpu_torch.simulate import make_pangenome_graph
    from psi_tpu_torch.tools import bacterial
    from psi_tpu_torch.tools.ggsim import simulate_haplotypes

    ref_len, rate = 30000, 0.02
    theirs = make_pangenome_graph(ref_len, rate, seed=1)
    bacterial.write_gfa(theirs, str(tmp_path / "theirs.gfa"))
    their_haps = [sequence(h) for _, h in simulate_haplotypes(theirs, 4, 7)]
    bacterial.write_reads(their_haps, str(tmp_path / "theirs.fq"), 500, 11)

    ours = gen.make_pangenome_graph(ref_len, rate, seed=1)
    gen.write_gfa(ours, str(tmp_path / "ours.gfa"))
    haps = gen.simulate_haplotypes(ours, 4, 7)
    gen.write_fastq(gen.draw_reads(haps, 500, bacterial.READ_LEN,
                                   bacterial.ERROR_RATE, 11),
                    str(tmp_path / "ours.fq"))

    assert haps == their_haps
    for name in ("gfa", "fq"):
        assert ((tmp_path / f"ours.{name}").read_bytes()
                == (tmp_path / f"theirs.{name}").read_bytes())


def test_derive_seeds_takes_any_whole_number():
    a = gen.derive_seeds(2**31 + 12345)
    assert a == gen.derive_seeds(2**31 + 12345)
    assert a != gen.derive_seeds(2**31 + 12346)
    assert all(0 <= s < 2**32 for s in gen.derive_seeds(3 * 2**40))
    np.random.RandomState(a[0])
