"""The cost functions against counts made by hand at tiny shapes."""
from portbench.costs import direction, multinomial_logistic, \
    sparse_binary_logistic


def test_direction_by_hand():
    # m = 1, n = 3: W is 2 x 3 (24 bytes), g and d 12 bytes each, C 2 x 2
    # (16 bytes), gamma 4; W g and W^T u 12 flops each, C u 8, gamma g + 6
    assert direction.cost(1, 3) == (12 + 8 + 12 + 6, 24 + 12 + 12 + 16 + 4)


def test_dense_step_by_hand():
    cfg = dict(batch_size=1, n_features=1, n_classes=1, mem_size=1,
               bfgs_upd_freq=1)
    # n = 2.  Flops of a step: the gradient 4, its penalty 4, the direction
    # 28 (as above at m = 1, n = 2), the guard's norm 4, x -= eta d 4,
    # x_sum += x 2.  Bytes: the row and its label 8, x read 8, W, C and
    # gamma 36, x written 8, x_sum read and written 16.  The boundary on
    # its one row: the product 6 and its penalty 4, x_avg and s 4, the
    # curvature's two dots 8, the Gram's two columns 16 flops; the row 8,
    # x_sum and x_avg_prev read 16, x_avg_prev written 8, the pair written
    # 16, W read 16, x_sum reset 8 bytes.
    assert multinomial_logistic.size(cfg) == 2
    assert multinomial_logistic.step(cfg) == (46 + 38, 76 + 72)


def test_sparse_step_by_hand():
    cfg = dict(batch_size=1, pad_to=1, n_features=2, mem_size=1,
               bfgs_upd_freq=1)
    # As the dense count, with a gradient of 4 flops on one slot and a row
    # of 12 bytes (an 8-byte id and a value) and a 4-byte label; the
    # boundary's product 8 flops.
    assert sparse_binary_logistic.size(cfg) == 2
    assert sparse_binary_logistic.step(cfg) == (46 + 40, 84 + 80)
